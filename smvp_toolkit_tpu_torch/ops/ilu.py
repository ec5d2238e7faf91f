"""Incomplete Cholesky (IC(0)) and the fixed-sweep triangular apply.

Counterpart of the IC(0) half of the JAX package's ``ops/ilu.py``.

* **Factorization is host-side, encode-time**: a sequential row
  elimination in float64, run once per matrix like the SELL planner. By
  default it runs the port's C++ copy of the JAX package's native pass
  (``csrc/ilu.cpp``, built by ``ops/_build.py`` with the host compiler);
  :func:`_ic0_pass` is the numpy loop it copies, bit for bit, and runs
  only when asked (``ic0(csr, native=False)``). If the C++ pass cannot be
  built, :func:`ic0` raises rather than run an interpreted loop over
  every row and its coupled rows at a million rows.
* **Application is a fixed-sweep truncated Neumann solve**: for a
  triangular ``T = D + N`` (``N`` strictly triangular, nilpotent),
  ``z_s = sum_{k<s} (-D⁻¹N)^k D⁻¹ r`` as ``s`` SpMV sweeps. With equal
  sweep counts the IC(0) apply ``P_Lᵀ·P_L`` is symmetric positive definite
  for every sweep count, so CG may use it.

The factors are the port's :class:`~smvp_toolkit_tpu_torch.formats.csr.
CSRMatrix` (padded to 128 entries) and a diagonal tensor, on the input
matrix's device and in its value dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix, csr_encode

__all__ = ["IC0Factors", "ic0", "trisolve_neumann"]

_PAD = 128  # entry padding of the factor CSRs
_F32_SAFE = 1e30  # factor-entry magnitude cap (float32 storage)


@dataclasses.dataclass(frozen=True, eq=False)
class IC0Factors:
    """A ≈ L·Lᵀ (SPD): strict lower triangle, its transpose, diag(L).

    ``strict_t`` is materialized at factorization time so the backward
    solve is a plain CSR SpMV too. ``eq=False`` keeps identity hashing, so
    the fused solver can key its plans on the factors.
    """

    strict: CSRMatrix  # strictly lower part of L
    strict_t: CSRMatrix  # its transpose (strictly upper)
    diag: torch.Tensor  # [nrows], diag(L) > 0

    @property
    def shape(self) -> Tuple[int, int]:
        return self.strict.shape


def _csr_host(csr: CSRMatrix):
    """(row_ptr, col_ind, vals) as trimmed host int64 / float64 arrays."""
    rp = csr.row_ptr.cpu().numpy().astype(np.int64)
    true_nnz = int(rp[csr.shape[0]])
    ci = csr.col_ind[:true_nnz].cpu().numpy().astype(np.int64)
    v = csr.vals[:true_nnz]
    if v.is_complex():
        raise ValueError(
            "incomplete factorizations support real matrices only"
        )
    return rp, ci, v.double().cpu().numpy()


def _tri_csr(rows, cols, vals, n: int, dtype, device) -> CSRMatrix:
    """Encode host triplets of a (strictly) triangular part as CSR."""
    coo = COOMatrix.from_numpy(
        np.asarray(rows, np.int32), np.asarray(cols, np.int32),
        np.asarray(vals, np.float64), shape=(n, n), dtype=dtype,
        pad_to=_PAD, device=device,
    )
    return csr_encode(coo)


def _shift_ladder(scale: float):
    """Manteuffel shift candidates: 0, then scale·1e-3·10^k."""
    base = max(scale, 1e-30) * 1e-3
    return [0.0] + [base * 10.0**k for k in range(8)]


def _factors_usable(arrays, repaired: int, n: int) -> bool:
    """Accept a factorization pass: finite, f32-safe, few repaired pivots
    (a cascade past 1% of rows means the elimination feeds on garbage)."""
    if repaired > max(1, n // 100):
        return False
    return all(
        a.size == 0 or (np.isfinite(a).all() and np.abs(a).max() < _F32_SAFE)
        for a in arrays
    )


def _ic0_pass(rp, ci, v, n: int, shift: float, piv_floor: float):
    """One IC(0) sweep of A + shift·I, in place on the lower pattern.

    Returns ``(fac, lo_cut, diag, breakdowns)``: ``fac[rp[i]:lo_cut[i]]``
    are row i's strict-lower L values (slots at/above the diagonal are
    left untouched), ``diag`` is diag(L). ``csrc/ilu.cpp`` mirrors it
    operation for operation (bit-identical).
    """
    fac = v.copy()
    lo_cut = np.empty(n, np.int64)  # first non-lower slot per row
    diag = np.empty(n, np.float64)
    breakdowns = 0

    for i in range(n):
        lo, hi = int(rp[i]), int(rp[i + 1])
        cols_i = ci[lo:hi]
        cut = int(np.searchsorted(cols_i, i))
        lo_cut[i] = lo + cut
        a_ii = (
            float(v[lo + cut])
            if cut < cols_i.size and cols_i[cut] == i
            else 0.0
        ) + shift
        my_pos = {int(c): t for t, c in enumerate(cols_i[:cut])}
        for t in range(cut):
            k = int(cols_i[t])
            # dot over pattern(i) ∩ pattern(k) restricted to cols < k
            s = 0.0
            for u in range(int(rp[k]), int(lo_cut[k])):
                tu = my_pos.get(int(ci[u]))
                if tu is not None:
                    s += fac[lo + tu] * fac[u]
            fac[lo + t] = (fac[lo + t] - s) / diag[k]
        acc = 0.0
        for t in range(cut):
            acc += fac[lo + t] * fac[lo + t]
        pivot2 = a_ii - acc
        if pivot2 < piv_floor:
            breakdowns += pivot2 <= 0.0
            pivot2 = max(abs(a_ii), piv_floor)
        diag[i] = math.sqrt(pivot2)
    return fac, lo_cut, diag, breakdowns


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_ILU_SIGNATURES = {
    "ic0_pass": (ctypes.c_longlong, [
        _I64P, _I64P, _F64P, ctypes.c_longlong, ctypes.c_double,
        ctypes.c_double, _F64P, _I64P, _F64P,
    ]),
}


def _native_ic0_pass(rp, ci, v, n: int, shift: float, piv_floor: float):
    """:func:`_ic0_pass` in ``csrc/ilu.cpp`` (built on first use; raises
    if it cannot be built)."""
    from smvp_toolkit_tpu_torch.ops import _build

    lib = _build.load("ilu", _ILU_SIGNATURES)
    v64 = np.ascontiguousarray(v, dtype=np.float64)
    fac = v64.copy()
    lo_cut = np.empty(n, np.int64)
    diag = np.empty(n, np.float64)
    breakdowns = lib.ic0_pass(
        np.ascontiguousarray(rp, np.int64), np.ascontiguousarray(ci, np.int64),
        v64, n, shift, piv_floor, fac, lo_cut, diag,
    )
    return fac, lo_cut, diag, int(breakdowns)


def ic0(csr: CSRMatrix, *, native: bool = True) -> IC0Factors:
    """IC(0): incomplete Cholesky A ≈ L·Lᵀ on A's lower-triangle pattern.

    An isolated non-positive pivot is repaired with a scale-relative
    floor; a breakdown cascade (>1% of rows, or factor entries past the
    f32-safe range) restarts on ``A + αI`` with an escalating Manteuffel
    shift, warning with the shift used. Only the lower triangle of
    ``csr`` is read. ``native=False`` runs the numpy pass instead of the
    C++ copy (the two are bit-identical).
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"ic0 needs a square matrix, got {csr.shape}")
    rp, ci, v = _csr_host(csr)

    # Breakdown repair floor relative to the matrix scale: a zero or
    # negative pivot gives an O(sqrt(scale)) diagonal, a benign row.
    scale = float(np.max(np.abs(v))) if v.size else 1.0
    piv_floor = max(scale, 1e-30) * 1e-3

    pass_fn = _native_ic0_pass if native else _ic0_pass
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    slot = np.arange(ci.size, dtype=np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        for shift in _shift_ladder(scale):
            fac, lo_cut, diag, breakdowns = pass_fn(
                rp, ci, v, n, shift, piv_floor
            )
            low = slot < lo_cut[rows]
            if _factors_usable((fac[low], diag), breakdowns, n):
                break
        else:
            raise ValueError(
                "ic0: factorization kept breaking down even at the "
                "largest diagonal shift — the matrix is nowhere near "
                "SPD; use ilu0 + bicgstab/gmres instead"
            )
    if shift or breakdowns:
        what = []
        if shift:
            what.append(f"diagonal shift {shift:g}")
        if breakdowns:
            what.append(f"{breakdowns} locally repaired pivot(s)")
        warnings.warn(
            "ic0: input is SPD-marginal; completed with "
            + " and ".join(what)
            + " — the factor remains PD and usable",
            stacklevel=2,
        )
    l_rows, l_cols, l_vals = rows[low], ci[low], fac[low]
    dtype, dev = csr.dtype, csr.device
    diag_t = torch.from_numpy(diag.astype(np.float32)).to(dtype).to(dev)
    return IC0Factors(
        strict=_tri_csr(l_rows, l_cols, l_vals, n, dtype, dev),
        strict_t=_tri_csr(l_cols, l_rows, l_vals, n, dtype, dev),
        diag=diag_t,
    )


def trisolve_neumann(
    strict: CSRMatrix,
    diag: Optional[torch.Tensor],
    r: torch.Tensor,
    sweeps: int = 4,
    spmv: Optional[Callable] = None,
) -> torch.Tensor:
    """Approximate ``(D + N)⁻¹ r`` by ``sweeps`` Jacobi iterations.

    ``N`` (``strict``) must be strictly triangular: the sweep-``s`` result
    is the truncated Neumann series ``sum_{k<s} (-D⁻¹N)^k D⁻¹ r``, exact
    past the nilpotency index. ``diag=None`` is a unit diagonal. ``spmv``
    defaults to the factor's cached SELL operator
    (``spmv_sell.spmv_csr_sell``).
    """
    if spmv is None:
        from smvp_toolkit_tpu_torch.ops.spmv_sell import spmv_csr_sell as spmv
    if diag is None:
        z = r
        for _ in range(sweeps - 1):
            z = r - spmv(strict, z)
        return z
    inv_d = 1.0 / diag
    z = inv_d * r
    for _ in range(sweeps - 1):
        z = inv_d * (r - spmv(strict, z))
    return z
