"""Iterative SPD solvers on encoded sparse matrices (CSR by default).

Counterpart of the SPD part of the JAX package's ``models/solvers.py``:
conjugate gradient, Jacobi- and generally-preconditioned CG, the IC(0)
preconditioner, Chebyshev iteration, and Lanczos with its host-side
tridiagonal eigensolve. Plain functions on tensors, with the same
recurrences, update order and breakdown guards as the JAX functions.

The SpMV is injectable as ``spmv(matrix, x)``, as in JAX; it defaults to
``spmv_sell.spmv_csr_sell``, the matrix's cached SELL operator, which
launches the SELL kernels on the card and runs their plain versions on
the CPU. Each step launches its SpMV and a few vector operations; the
whole-solve-in-one-launch versions are ``ops.cg_fused`` and
``ops.pcg_fused``.

``tol`` (a relative residual target, ``|r| / |b|``) stops a solve at the
first step whose residual norm reaches it, checked on the host after
each step. The residual history keeps its ``num_iters`` length; entries
past the stopping step repeat the final norm, so ``res[-1]`` is the last
residual either way (the JAX ``_while_solve`` contract).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "conjugate_gradient",
    "lanczos",
    "lanczos_eigsh",
    "chebyshev",
    "pcg",
    "pcg_precond",
    "ic0_preconditioner",
]


def _default_spmv(spmv: Optional[Callable]) -> Callable:
    if spmv is not None:
        return spmv
    from smvp_toolkit_tpu_torch.ops.spmv_sell import spmv_csr_sell

    return spmv_csr_sell


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _while_solve(step, carry, b: torch.Tensor, num_iters: int,
                 tol: Optional[float]):
    """Run ``carry -> (carry, |r|)`` for ``num_iters`` steps, or until the
    residual norm reaches ``tol·max(|b|, 1e-30)`` (float32, as the JAX
    target) when ``tol`` is given. Returns ``(carry[0], res_norms)``: the
    history has ``num_iters`` entries, those past the stopping step
    repeating the final norm. The first carry element must be x."""
    hist = torch.zeros(num_iters, dtype=torch.float32, device=b.device)
    target = None
    if tol is not None:
        target = float(tol * torch.clamp(_norm(b).float(), min=1e-30))
    i = 0
    while i < num_iters:
        carry, nrm = step(carry)
        hist[i] = nrm
        i += 1
        if target is not None and float(nrm) <= target:
            break
    if 0 < i < num_iters:
        hist[i:] = hist[i - 1]
    return carry[0], hist


def conjugate_gradient(matrix, b: torch.Tensor,
                       x0: Optional[torch.Tensor] = None,
                       num_iters: int = 50, spmv: Optional[Callable] = None,
                       tol: Optional[float] = None):
    """Solve A x = b for symmetric positive-definite A by CG.

    Returns ``(x, residual_norms)``; ``tol`` stops early (module
    docstring).
    """
    spmv = _default_spmv(spmv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    p = r
    rs = torch.dot(r, r)

    def step(carry):
        x, r, p, rs = carry
        ap = spmv(matrix, p)
        alpha = rs / torch.clamp(torch.dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        return (x, r, p, rs_new), torch.sqrt(torch.abs(rs_new))

    return _while_solve(step, (x, r, p, rs), b, num_iters, tol)


def lanczos(matrix, v0: torch.Tensor, num_iters: int = 30,
            spmv: Optional[Callable] = None):
    """Lanczos tridiagonalization of a symmetric A (single pass, no
    reorthogonalization). Returns ``(alphas, betas, V)``: the tridiagonal
    coefficients and the Krylov basis, one row per step."""
    spmv = _default_spmv(spmv)
    v_prev = torch.zeros_like(v0)
    v = v0 / _norm(v0)
    beta = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas, basis = [], [], []
    for _ in range(num_iters):
        w = spmv(matrix, v) - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta = _norm(w)
        alphas.append(alpha)
        betas.append(beta)
        basis.append(v)
        v_prev, v = v, w / torch.clamp(beta, min=1e-30)
    return torch.stack(alphas), torch.stack(betas), torch.stack(basis)


def lanczos_eigsh(matrix, v0: torch.Tensor, num_iters: int = 30, k: int = 4,
                  spmv: Optional[Callable] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Extremal eigenvalues of symmetric A: :func:`lanczos`, then the
    tridiagonal eigenproblem on the host (scipy ``eigh_tridiagonal``).
    Returns ``(lows, highs)``, the ``k`` smallest and largest Ritz values
    (e.g. spectrum bounds for :func:`chebyshev`)."""
    from scipy.linalg import eigh_tridiagonal

    alphas, betas, _ = lanczos(matrix, v0, num_iters=num_iters, spmv=spmv)
    a = alphas.double().cpu().numpy()
    bt = betas.double().cpu().numpy()[:-1]
    ritz = eigh_tridiagonal(a, bt, eigvals_only=True)
    k = min(k, len(ritz))
    return ritz[:k], ritz[-k:]


def chebyshev(matrix, b: torch.Tensor, lambda_min: float, lambda_max: float,
              x0: Optional[torch.Tensor] = None, num_iters: int = 50,
              spmv: Optional[Callable] = None):
    """Chebyshev iteration for SPD A with spectrum in [lambda_min,
    lambda_max]: one SpMV and AXPYs per step, no inner products. Returns
    ``(x, residual_norms)`` (the norms are observed, not used)."""
    spmv = _default_spmv(spmv)
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    d = r / theta
    rho = 1.0 / sigma1
    res = torch.zeros(num_iters, dtype=torch.float32, device=b.device)
    for k in range(num_iters):
        x = x + d
        r = r - spmv(matrix, d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
        res[k] = _norm(r)
    return x, res


def pcg_precond(matrix, b: torch.Tensor, precond: Callable,
                x0: Optional[torch.Tensor] = None, num_iters: int = 50,
                spmv: Optional[Callable] = None,
                tol: Optional[float] = None):
    """CG with a preconditioner callable ``z = precond(r)``, which must
    apply a constant SPD operator. Returns ``(x, residual_norms)``."""
    spmv = _default_spmv(spmv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)

    def step(carry):
        x, r, z, p, rz = carry
        ap = spmv(matrix, p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new), _norm(r)

    return _while_solve(step, (x, r, z, p, rz), b, num_iters, tol)


def pcg(matrix, b: torch.Tensor, diag: torch.Tensor,
        x0: Optional[torch.Tensor] = None, num_iters: int = 50,
        spmv: Optional[Callable] = None, tol: Optional[float] = None):
    """Jacobi-preconditioned CG, M = diag(A): :func:`pcg_precond` with
    ``z = D⁻¹ r`` (a zero diagonal entry counts as 1)."""
    inv_d = 1.0 / torch.where(diag.abs() > 1e-30, diag,
                              torch.ones_like(diag))
    return pcg_precond(matrix, b, lambda r: inv_d * r, x0=x0,
                       num_iters=num_iters, spmv=spmv, tol=tol)


def ic0_preconditioner(factors, sweeps: int = 4,
                       spmv: Optional[Callable] = None,
                       op_builder: Optional[Callable] = None) -> Callable:
    """IC(0) preconditioner factory: ``apply(r) ≈ (L·Lᵀ)⁻¹ r`` by two
    fixed-sweep truncated-Neumann triangular solves (``ops.ilu``), exactly
    symmetric positive definite for every ``sweeps``.

    ``op_builder`` receives each factor CSR once and returns an operator
    ``op(x)`` (e.g. ``spmv_sell.sell_op_csr``); without it the solves run
    ``spmv(factor, x)``, by default the factor's cached SELL operator.
    """
    from smvp_toolkit_tpu_torch.ops.ilu import trisolve_neumann

    spmv_l = spmv_lt = spmv
    if op_builder is not None:
        op_l, op_lt = op_builder(factors.strict), op_builder(factors.strict_t)
        spmv_l = lambda _m, z: op_l(z)  # noqa: E731
        spmv_lt = lambda _m, z: op_lt(z)  # noqa: E731

    def apply(r: torch.Tensor) -> torch.Tensor:
        z = trisolve_neumann(factors.strict, factors.diag, r, sweeps=sweeps,
                             spmv=spmv_l)
        return trisolve_neumann(factors.strict_t, factors.diag, z,
                                sweeps=sweeps, spmv=spmv_lt)

    return apply
