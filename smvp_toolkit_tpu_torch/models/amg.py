"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

Counterpart of the JAX package's ``models/amg.py``. Where IC(0) cuts
Poisson iteration counts about 3x, a V-cycle cuts them to O(10),
independent of the problem size.

* **Set-up is host-side, encode-time** (numpy and scipy, as in the JAX
  package): strength graph, greedy aggregation, the smoothed prolongator
  ``P = (I − ω D⁻¹A) P₀`` and the Galerkin coarse operators
  ``A_{l+1} = Pᵀ A_l P`` by SpGEMM. The aggregation pass runs in
  ``csrc/amg.cpp`` (built on first use; a failed build raises), or in the
  numpy loop it copies when asked (``native=False``).
* **The apply runs on the device**: every level's A, P and Pᵀ is a CSR
  matrix on the input's device, applied by a per-level operator
  (``op_builder``, e.g. ``spmv_sell.sell_op_csr``: the SELL kernels on the
  card; by default the matrix's cached SELL operator), the smoother is
  damped Jacobi or Chebyshev in D⁻¹A (diagonal multiplies, no trisolves),
  and the coarsest level is one dense (n_c × n_c) inverse applied by a
  dense product. An (n, k) block runs the whole V-cycle k wide, on the
  operators' ``matmat`` (the k-column kernels).

CG safety: damped Jacobi's error propagator ``I − ωD⁻¹A`` is
A-self-adjoint for SPD A, so the symmetric V(ν,ν) cycle (equal pre- and
post-sweeps) is a symmetric positive-definite preconditioner.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["AMGLevel", "amg_setup", "amg_preconditioner"]

# Largest coarse level the set-up will densify and invert (64 MB float32
# at 4096²); past this a stalled aggregation is an error, not an OOM.
_DENSE_LIMIT = 4096


@dataclasses.dataclass
class AMGLevel:
    """One level of the hierarchy (device tensors inside).

    The coarsest level has ``coarse_inv`` set and no P, Pᵀ or A.
    """

    n: int
    a_csr: object = None        # CSRMatrix of A_l
    p_csr: object = None        # prolongator (n_l, n_{l+1})
    pt_csr: object = None       # restriction (n_{l+1}, n_l)
    inv_diag: torch.Tensor = None  # (n_l,) float32, zeros patched to 1
    omega: float = 0.0          # damped-Jacobi weight 4/(3ρ(D⁻¹A))
    rho: float = 0.0            # inflated ρ(D⁻¹A) estimate (smoothers)
    coarse_inv: torch.Tensor = None  # dense (n_c, n_c) inverse (last level)


def _scipy_csr(matrix):
    """CSRMatrix → scipy csr (float64, trimmed of padding)."""
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.ops.ilu import _csr_host

    rp, ci, v = _csr_host(matrix)
    n, m = matrix.shape
    return sp.csr_matrix(
        (np.asarray(v, np.float64), ci, rp[: n + 1]), shape=(n, m)
    )


def _strength_graph(a, theta):
    """Symmetric strength of connection: |a_ij| ≥ θ·√(a_ii·a_jj), built as
    one COO holding both (i, j) and (j, i), whose CSR conversion merges the
    duplicates."""
    import scipy.sparse as sp

    d = np.abs(a.diagonal())
    d = np.where(d > 0, d, 1.0)
    coo = a.tocoo()
    off = coo.row != coo.col
    r, c, v = coo.row[off], coo.col[off], coo.data[off]
    strong = np.abs(v) >= theta * np.sqrt(d[r] * d[c])
    r, c = r[strong], c[strong]
    return sp.csr_matrix(
        (np.ones(2 * len(r)), (np.concatenate([r, c]),
                               np.concatenate([c, r]))),
        shape=a.shape,
    )


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_AMG_SIGNATURES = {
    "aggregate_pass": (ctypes.c_longlong, [
        _I64P, _I64P, ctypes.c_longlong, _I64P,
    ]),
}


def _aggregate_native(s):
    """:func:`_aggregate_numpy` in ``csrc/amg.cpp`` (built on first use;
    raises if it cannot be built)."""
    from smvp_toolkit_tpu_torch.ops import _build

    lib = _build.load("amg", _AMG_SIGNATURES)
    n = s.shape[0]
    agg = np.empty(n, np.int64)
    nxt = lib.aggregate_pass(
        np.ascontiguousarray(s.indptr, np.int64),
        np.ascontiguousarray(s.indices, np.int64),
        n, agg,
    )
    return agg, int(nxt)


def _aggregate_numpy(s):
    """Greedy standard aggregation over the strength graph.

    Pass 1 seeds an aggregate at every node whose strong neighbourhood is
    untouched; pass 2 attaches leftovers to an adjacent aggregate; pass 3
    makes singletons of the rest. ``csrc/amg.cpp`` copies it pass for
    pass (identical integer outputs).
    """
    n = s.shape[0]
    indptr, indices = s.indptr, s.indices
    agg = np.full(n, -1, np.int64)
    nxt = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = nxt
            agg[nbrs] = nxt
            nxt += 1
    for i in range(n):
        if agg[i] == -1:
            nbrs = indices[indptr[i]:indptr[i + 1]]
            owned = nbrs[agg[nbrs] != -1]
            if owned.size:
                agg[i] = agg[owned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = nxt
            nxt += 1
    return agg, nxt


def _rho_dinv_a(a, iters=15):
    """Power-iteration estimate of ρ(D⁻¹A) (host, float64), inflated by
    1.1: the iteration converges from below, and ω = 4/(3ρ) would cross
    the Jacobi stability bound 2/ρ under a 33% underestimate."""
    d = a.diagonal()
    d = np.where(np.abs(d) > 1e-30, d, 1.0)
    x = np.random.default_rng(0).standard_normal(a.shape[0])
    x /= np.linalg.norm(x)
    rho = 2.0
    for _ in range(iters):
        y = (a @ x) / d
        nrm = np.linalg.norm(y)
        if nrm < 1e-30:
            break
        rho, x = nrm, y / nrm
    return 1.1 * max(float(rho), 1e-12)


def amg_setup(
    matrix,
    *,
    theta: float = 0.08,
    coarse_size: int = 128,
    max_levels: int = 12,
    pad_to: int = 128,
    native: bool = True,
) -> List[AMGLevel]:
    """Build the smoothed-aggregation hierarchy (host-side).

    ``matrix`` is a CSRMatrix (SPD assumed, as for the other SPD
    preconditioners); the levels' matrices and vectors live on its
    device. Coarsening stops at ``coarse_size`` rows (the dense-inverse
    level) or when aggregation stalls; a stalled level above
    ``_DENSE_LIMIT`` rows raises ValueError. ``native=False`` aggregates
    in numpy instead of ``csrc/amg.cpp`` (identical results).
    """
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode

    n, m = matrix.shape
    if n != m:
        raise ValueError(f"amg needs a square matrix, got {matrix.shape}")
    dev = matrix.device
    aggregate = _aggregate_native if native else _aggregate_numpy

    def _encode(mat):
        coo = mat.tocoo()
        return csr_encode(COOMatrix.from_numpy(
            coo.row.astype(np.int32), coo.col.astype(np.int32),
            coo.data.astype(np.float32), shape=mat.shape, pad_to=pad_to,
            device=dev,
        ))

    a = _scipy_csr(matrix)
    levels: List[AMGLevel] = []
    for li in range(max_levels - 1):
        if a.shape[0] <= coarse_size:
            break
        agg, nc = aggregate(_strength_graph(a, theta))
        if nc >= a.shape[0]:  # aggregation stalled: stop coarsening
            break
        rho = _rho_dinv_a(a)
        omega = 4.0 / (3.0 * rho)
        p0 = sp.csr_matrix(
            (np.ones(a.shape[0]), (np.arange(a.shape[0]), agg)),
            shape=(a.shape[0], nc),
        )
        d = a.diagonal()
        d = np.where(np.abs(d) > 1e-30, d, 1.0)
        dinv_a = sp.diags(1.0 / d) @ a
        p = (p0 - omega * (dinv_a @ p0)).tocsr()
        p.eliminate_zeros()
        levels.append(AMGLevel(
            n=a.shape[0],
            # Level 0 reuses the caller's matrix, so its cached SELL
            # operator is the one the solver's own SpMV uses.
            a_csr=matrix if li == 0 else _encode(a),
            p_csr=_encode(p),
            pt_csr=_encode(p.T.tocsr()),
            inv_diag=torch.from_numpy((1.0 / d).astype(np.float32)).to(dev),
            omega=float(omega),
            rho=float(rho),
        ))
        a = (p.T @ a @ p).tocsr()
        a.eliminate_zeros()
    if a.shape[0] > max(coarse_size, _DENSE_LIMIT):
        raise ValueError(
            f"amg coarsening stalled at n={a.shape[0]} (dense coarse "
            "solve would not fit): too few strong connections for "
            "smoothed aggregation — lower theta, or use a one-level "
            "preconditioner (jacobi/ssor/ic0); strongly diagonally "
            "dominant systems rarely need multigrid at all"
        )
    dense = np.asarray(a.todense(), np.float64)
    # A tiny ridge keeps a semi-definite coarse operator invertible (a
    # pure-Neumann block); negligible for definite ones.
    ridge = 1e-12 * max(np.abs(dense).max(), 1.0)
    coarse_inv = np.linalg.inv(dense + ridge * np.eye(a.shape[0]))
    levels.append(AMGLevel(
        n=a.shape[0],
        coarse_inv=torch.from_numpy(coarse_inv.astype(np.float32)).to(dev),
    ))
    return levels


def amg_preconditioner(
    matrix,
    *,
    sweeps: int = 1,
    cycles: int = 1,
    smoother: str = "jacobi",
    op_builder: Optional[Callable] = None,
    spmv: Optional[Callable] = None,
    levels: Optional[List[AMGLevel]] = None,
    **setup_kw,
) -> Callable:
    """AMG V-cycle preconditioner factory for ``pcg_precond``.

    ``sweeps`` smoothing sweeps before and after the coarse correction at
    every level (the symmetric V(ν,ν) cycle, CG-safe); ``cycles`` stacks
    V-cycles per apply. ``smoother`` is damped Jacobi (default) or
    ``"chebyshev"``: a degree-``sweeps`` polynomial in D⁻¹A on [ρ/30, ρ].
    Both error propagators are polynomials in D⁻¹A, so the cycle stays
    SPD.

    ``op_builder`` receives every level's A, P and Pᵀ once and returns an
    operator ``op(x)`` (``spmv_sell.sell_op_csr``: the SELL kernels, with
    ``matmat`` for blocks). Without it, ``spmv(matrix, x)`` applies them:
    by default each matrix's cached SELL operator; the plain-PyTorch CSR
    SpMV (``spmv_torch.spmv_csr``) gets its CSR SpMM for blocks; any other
    ``spmv`` applies a block column by column. Pass a prebuilt ``levels``
    (:func:`amg_setup`) to reuse one hierarchy; extra keywords go to
    :func:`amg_setup`.

    The apply takes a vector (n,) or a block (n, k) and declares
    ``apply.supports_block = True``.
    """
    from smvp_toolkit_tpu_torch.ops import spmv_sell, spmv_torch

    if sweeps < 1 or cycles < 1:
        raise ValueError("amg needs sweeps >= 1 and cycles >= 1")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(
            f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}"
        )
    if levels is None:
        levels = amg_setup(matrix, **setup_kw)
    else:
        if setup_kw:
            raise ValueError(
                "setup keywords have no effect with a prebuilt "
                f"levels: {sorted(setup_kw)}"
            )
        if matrix is not None and levels[0].n != matrix.shape[0]:
            raise ValueError(
                f"prebuilt hierarchy is for n={levels[0].n}, "
                f"matrix has n={matrix.shape[0]}"
            )

    def _op(csr):
        if op_builder is not None:
            return op_builder(csr)
        if spmv is None:
            return spmv_sell.sell_op_csr(csr)
        f = lambda xx, _c=csr: spmv(_c, xx)  # noqa: E731
        if spmv is spmv_torch.spmv_csr:
            f.matmat = lambda XX, _c=csr: spmv_torch.spmm_csr(_c, XX)
        return f

    def _ap(op, z):
        """Apply a level operator to a vector or an (n, k) block: a block
        rides the operator's ``matmat`` where it has one, else one apply
        per column."""
        if z.dim() == 1:
            return op(z)
        mm = getattr(op, "matmat", None)
        if mm is not None:
            return mm(z)
        return torch.stack([op(z[:, j]) for j in range(z.shape[1])], dim=1)

    ops = [
        (None if lv.a_csr is None else _op(lv.a_csr),
         None if lv.p_csr is None else _op(lv.p_csr),
         None if lv.pt_csr is None else _op(lv.pt_csr))
        for lv in levels
    ]

    def _smooth(lv, a_op, x, b):
        """``sweeps`` smoothing steps; ``x=None`` starts from 0 (the first
        residual is b, which saves an A apply)."""
        wd = lv.omega * lv.inv_diag
        di = lv.inv_diag
        if b.dim() == 2:  # block apply: broadcast over the k columns
            wd, di = wd[:, None], di[:, None]
        if smoother == "jacobi":
            if x is None:
                x = wd * b
                extra = sweeps - 1
            else:
                extra = sweeps
            for _ in range(extra):
                x = x + wd * (b - _ap(a_op, x))
            return x
        # Chebyshev on D⁻¹A over [ρ/30, ρ] (three-term recurrence, degree
        # = sweeps): damps the whole upper spectrum.
        hi = lv.rho
        lo = hi / 30.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho_p = 1.0 / sigma
        r = b if x is None else b - _ap(a_op, x)
        d = (1.0 / theta) * (di * r)
        x = d if x is None else x + d
        for _ in range(sweeps - 1):
            r = b - _ap(a_op, x)
            rho_n = 1.0 / (2.0 * sigma - rho_p)
            d = (rho_n * rho_p) * d + (2.0 * rho_n / delta) * (di * r)
            x = x + d
            rho_p = rho_n
        return x

    def _vcycle(li: int, b: torch.Tensor) -> torch.Tensor:
        lv = levels[li]
        if lv.coarse_inv is not None:
            return lv.coarse_inv @ b  # (n_c,) and (n_c, k) alike
        a_op, p_op, pt_op = ops[li]
        x = _smooth(lv, a_op, None, b)
        r = b - _ap(a_op, x)
        xc = _vcycle(li + 1, _ap(pt_op, r)[: levels[li + 1].n])
        x = x + _ap(p_op, xc)[: lv.n]
        return _smooth(lv, a_op, x, b)

    n0 = levels[0].n
    # A coarse-only hierarchy solves exactly in one pass; extra cycles
    # would need an A operator the coarse level does not carry.
    n_cycles = cycles if levels[0].coarse_inv is None else 1

    def apply(r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ r for a vector (n,) or a block (n, k)."""
        b = r[:n0].float()
        z = _vcycle(0, b)
        for _ in range(n_cycles - 1):
            z = z + _vcycle(0, b - _ap(ops[0][0], z))
        if r.shape[0] > n0:
            pad = (0, 0) * (r.dim() - 1) + (0, r.shape[0] - n0)
            z = torch.nn.functional.pad(z, pad)
        return z.to(r.dtype)

    # Block consumers (lobpcg, block_cg) hand the whole (n, k) block only
    # to appliers that declare it.
    apply.supports_block = True
    return apply
