"""Iterative solvers on encoded sparse matrices (CSR by default).

Counterpart of the JAX package's ``models/solvers.py``: power iteration
and PageRank; conjugate gradient, Jacobi- and generally-preconditioned
CG, block CG, CGLS and Jacobi iteration; BiCGSTAB, restarted GMRES and
MINRES for nonsymmetric and indefinite systems; Chebyshev iteration,
Lanczos with its host-side tridiagonal eigensolve and LOBPCG; the
preconditioner factories (truncated Neumann, Chebyshev polynomial,
IC(0), ILU(0), SSOR, block Jacobi; AMG is ``models.amg``); and
mixed-precision iterative refinement (``refine_solve``) on the
double-float residual of ``ops.precision``. Plain functions on tensors,
with the same recurrences, update order and breakdown guards as the JAX
functions.

The SpMV is injectable as ``spmv(matrix, x)`` (the block solvers' SpMM as
``spmm(matrix, X)``), as in JAX; it defaults to the matrix's cached SELL
operator (``spmv_sell.spmv_csr_sell``, ``SellSpMV.matmat``), which
launches the SELL kernels on the card and runs their plain versions on
the CPU. Each step launches its SpMV and a few vector operations; the
whole-solve-in-one-launch versions are ``ops.cg_fused`` and
``ops.pcg_fused``.

``tol`` (a relative residual target, ``|r| / |b|``) stops a solve at the
first step whose residual norm reaches it, checked on the host after
each step (GMRES: after each restart cycle). The residual history keeps
its ``num_iters`` length; entries past the stopping step repeat the final
norm, so ``res[-1]`` is the last residual either way (the JAX
``_while_solve`` contract). Power iteration and PageRank stop on their
own targets (the change of the eigenvalue estimate, the L1 change of the
rank vector).

Inner products are ``torch.vdot``, which conjugates its first argument as
``jnp.vdot`` does (``torch.dot`` does not: on a complex vector it gives
Σ v², not |v|²), so CG, Jacobi-PCG, BiCGSTAB, GMRES and MINRES also solve
complex (Hermitian, for CG and MINRES) systems, as the JAX CLI runs them.
On real vectors ``vdot`` is ``dot``. The denominator guards that the JAX
functions take with ``jnp.maximum(·, 1e-30)`` go through :func:`_floor`,
which orders a complex value as ``jnp.maximum`` does; on real values it is
the ``torch.clamp`` they always were.

Two departures from the JAX functions, both stated where they are tested
(``tests/test_torch_krylov.py``, ``tests/test_torch_lobpcg.py``): GMRES
solves its small least-squares problem by the pseudo-inverse (an SVD with
the cutoff of ``jnp.linalg.lstsq(rcond=None)``), since ``torch.linalg.
lstsq`` on the card assumes full rank; and LOBPCG draws its first search
direction from a ``torch.Generator`` seeded 7 (:func:`_random_block`),
where the JAX function draws from ``jax.random.PRNGKey(7)``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "power_iteration",
    "pagerank",
    "conjugate_gradient",
    "bicgstab",
    "jacobi",
    "lanczos",
    "cgls",
    "gmres",
    "pcg",
    "pcg_precond",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "chebyshev",
    "minres",
    "lanczos_eigsh",
    "lobpcg",
    "block_cg",
    "refine_solve",
    "ic0_preconditioner",
    "ilu_preconditioner",
    "ssor_preconditioner",
    "block_jacobi_preconditioner",
]


def _default_spmv(spmv: Optional[Callable]) -> Callable:
    if spmv is not None:
        return spmv
    from smvp_toolkit_tpu_torch.ops.spmv_sell import spmv_csr_sell

    return spmv_csr_sell


def _default_spmm(spmm: Optional[Callable]) -> Callable:
    if spmm is not None:
        return spmm
    from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr

    return lambda matrix, X: sell_op_csr(matrix).matmat(X)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _rdt(t: torch.Tensor) -> torch.dtype:
    """The dtype of residual norms: float64 for float64 and complex128
    systems (the JAX functions' real dtype), float32 otherwise."""
    return (torch.float64 if t.dtype in (torch.float64, torch.complex128)
            else torch.float32)


def _floor(v: torch.Tensor) -> torch.Tensor:
    """``max(v, 1e-30)`` as ``jnp.maximum`` takes it: on a complex ``v``
    the order is lexicographic (real part, then imaginary part), which
    ``torch.clamp`` refuses; on a real ``v`` it is the clamp itself."""
    if not v.is_complex():
        return torch.clamp(v, min=1e-30)
    keep = (v.real > 1e-30) | ((v.real == 1e-30) & (v.imag > 0))
    return torch.where(keep, v, torch.full_like(v, 1e-30))


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    """``v`` where ``|v| > 1e-30``, else 1e-30 (the JAX breakdown guard)."""
    return torch.where(v.abs() > 1e-30, v, torch.full_like(v, 1e-30))


def power_iteration(matrix, x0: torch.Tensor, num_iters: int = 50,
                    spmv: Optional[Callable] = None,
                    tol: Optional[float] = None):
    """Dominant eigenpair by repeated SpMV and normalization.

    Returns ``(eigenvalue estimate, eigenvector)``: the last normalization
    factor and the vector. ``tol`` stops once that factor changes by at
    most ``tol`` between steps (at most ``num_iters`` steps).
    """
    spmv = _default_spmv(spmv)
    x = x0 / _norm(x0)

    def advance(x):
        y = spmv(matrix, x)
        norm = _norm(y)
        return y / torch.clamp(norm, min=1e-30), norm

    lam = torch.zeros((), dtype=torch.float32, device=x0.device)
    prev, cur = float("inf"), 0.0  # the JAX loop's carry
    for _ in range(num_iters):
        if tol is not None and abs(cur - prev) <= tol:
            break
        x, lam = advance(x)
        if tol is not None:
            prev, cur = cur, float(lam)
    return lam, x


def pagerank(matrix, damping: float = 0.85, num_iters: int = 50,
             spmv: Optional[Callable] = None, tol: Optional[float] = None):
    """PageRank over a (column-stochastic) link matrix by iterated SpMV.

    ``tol`` is an L1-change target: the iteration stops once
    ``|r_new − r|_1 <= tol`` (at most ``num_iters`` steps).
    """
    spmv = _default_spmv(spmv)
    n = matrix.shape[1]
    r = torch.full((n,), 1.0 / n, dtype=matrix.vals.dtype,
                   device=matrix.vals.device)

    def advance(r):
        r_new = damping * spmv(matrix, r) + (1.0 - damping) / n
        return r_new / torch.clamp(r_new.sum(), min=1e-30)

    for _ in range(num_iters):
        r_new = advance(r)
        done = tol is not None and float((r_new - r).abs().sum()) <= tol
        r = r_new
        if done:
            break
    return r


def _while_solve(step, carry, b: torch.Tensor, num_iters: int,
                 tol: Optional[float]):
    """Run ``carry -> (carry, |r|)`` for ``num_iters`` steps, or until the
    residual norm reaches ``tol·max(|b|, 1e-30)`` (in the norms' dtype, as
    the JAX target) when ``tol`` is given. Returns ``(carry[0],
    res_norms)``: the history has ``num_iters`` entries, those past the
    stopping step repeating the final norm. The first carry element must
    be x."""
    rdt = _rdt(b)
    hist = torch.zeros(num_iters, dtype=rdt, device=b.device)
    target = None
    if tol is not None:
        target = float(tol * torch.clamp(_norm(b).to(rdt), min=1e-30))
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
    rs = torch.vdot(r, r)

    def step(carry):
        x, r, p, rs = carry
        ap = spmv(matrix, p)
        alpha = rs / _floor(torch.vdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.vdot(r, r)
        beta = rs_new / _floor(rs)
        p = r + beta * p
        return (x, r, p, rs_new), torch.sqrt(torch.abs(rs_new))

    return _while_solve(step, (x, r, p, rs), b, num_iters, tol)


def bicgstab(matrix, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             num_iters: int = 50, spmv: Optional[Callable] = None,
             tol: Optional[float] = None):
    """Solve A x = b for general (nonsymmetric) A by BiCGSTAB: two SpMVs a
    step. Returns ``(x, residual_norms)``; ``tol`` stops early."""
    spmv = _default_spmv(spmv)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    r_hat = r
    rho = torch.vdot(r_hat, r)
    p = r

    def step(carry):
        x, r, p, rho = carry
        v = spmv(matrix, p)
        alpha = rho / _nonzero(torch.vdot(r_hat, v))
        s = r - alpha * v
        t = spmv(matrix, s)
        omega = torch.vdot(t, s) / _nonzero(torch.vdot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = torch.vdot(r_hat, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        return (x, r, p, rho_new), _norm(r)

    return _while_solve(step, (x, r, p, rho), b, num_iters, tol)


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
        alpha = torch.vdot(v, w)
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


def cgls(matrix, matrix_t, b: torch.Tensor, num_iters: int = 50,
         spmv: Optional[Callable] = None, spmv_t: Optional[Callable] = None):
    """Least squares min ||A x − b|| by CGLS (CG on the normal equations).

    ``matrix_t`` is the encoded transpose (rectangular systems work).
    Returns ``(x, norms of Aᵀr)``.
    """
    spmv = _default_spmv(spmv)
    spmv_t = _default_spmv(spmv_t)
    x = torch.zeros(matrix.shape[1], dtype=b.dtype, device=b.device)
    r = b
    s = spmv_t(matrix_t, r)
    p = s
    gamma = torch.vdot(s, s)
    norms = torch.zeros(num_iters, dtype=_rdt(b), device=b.device)
    for k in range(num_iters):
        q = spmv(matrix, p)
        alpha = gamma / torch.clamp(torch.vdot(q, q), min=1e-30)
        x = x + alpha * p
        r = r - alpha * q
        s = spmv_t(matrix_t, r)
        gamma_new = torch.vdot(s, s)
        beta = gamma_new / torch.clamp(gamma, min=1e-30)
        p = s + beta * p
        gamma = gamma_new
        norms[k] = torch.sqrt(gamma_new)
    return x, norms


def jacobi(matrix, b: torch.Tensor, diag: torch.Tensor, num_iters: int = 50,
           spmv: Optional[Callable] = None) -> torch.Tensor:
    """Jacobi iteration x ← x + D⁻¹ (b − A x) from x = 0 (a zero diagonal
    entry counts as 1)."""
    spmv = _default_spmv(spmv)
    x = torch.zeros_like(b)
    inv_d = 1.0 / torch.where(diag.abs() > 1e-30, diag,
                              torch.ones_like(diag))
    for _ in range(num_iters):
        x = x + inv_d * (b - spmv(matrix, x))
    return x


def _precond_block(m, r: torch.Tensor) -> torch.Tensor:
    """Apply preconditioner ``m`` to an (n, k) residual block: appliers
    that declare ``m.supports_block`` (the AMG factory) take the whole
    block in one call, anything else is applied per column."""
    if m is None:
        return r
    if getattr(m, "supports_block", False):
        return m(r)
    return torch.stack([m(r[:, j]) for j in range(r.shape[1])], dim=1)


def block_cg(matrix, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             num_iters: int = 50, spmm: Optional[Callable] = None,
             m: Optional[Callable] = None):
    """Block (P)CG (O'Leary): A X = B for a block of k right-hand sides,
    one SpMM a step (by default the SELL operator's k-column launch), the
    k×k Gram solves dense on the device. ``m`` is an optional SPD
    preconditioner (block-capable appliers take the whole block). ``B``
    is (n, k); returns ``(X, residual_norms (num_iters, k))``."""
    spmm = _default_spmm(spmm)
    k = b.shape[1]
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmm(matrix, x)
    z = _precond_block(m, r)
    p = z
    gram = r.T @ z
    eye = torch.eye(k, dtype=b.dtype, device=b.device)

    def solve(g, rhs):
        # A tiny ridge keeps the Gram solve stable once columns converge.
        return torch.linalg.solve(g + 1e-12 * eye, rhs)

    res = torch.zeros(num_iters, k, dtype=_rdt(b), device=b.device)
    for it in range(num_iters):
        q = spmm(matrix, p)
        alpha = solve(p.T @ q, gram)
        x = x + p @ alpha
        r = r - q @ alpha
        z = _precond_block(m, r)
        gram_new = r.T @ z
        beta = solve(gram, gram_new)
        p = z + p @ beta
        gram = gram_new
        res[it] = torch.linalg.vector_norm(r, dim=0)
    return x, res


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
    res = torch.zeros(num_iters, dtype=_rdt(b), device=b.device)
    for k in range(num_iters):
        x = x + d
        r = r - spmv(matrix, d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
        res[k] = _norm(r)
    return x, res


def minres(matrix, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
           num_iters: int = 50, spmv: Optional[Callable] = None,
           tol: Optional[float] = None):
    """MINRES for symmetric, possibly indefinite A (Paige and Saunders):
    a three-term Lanczos recurrence with Givens QR on the fly. Returns
    ``(x, residual_norms)``, the norms being ``|eta|``, the residual norm
    of the minimum-residual iterate; ``tol`` stops early on it."""
    spmv = _default_spmv(spmv)
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - spmv(matrix, x)
    beta1 = _norm(r0)
    v = r0 / torch.clamp(beta1, min=1e-30)
    zero = torch.zeros_like(b)

    def step(carry):
        (x, v_prev, v, beta, eta, g0, g1, s0, s1, w2, w1) = carry
        # Lanczos step.
        av = spmv(matrix, v)
        w = av - beta * v_prev
        alpha = torch.vdot(v, w)
        w = w - alpha * v
        beta_new = _norm(w)
        v_next = w / torch.clamp(beta_new, min=1e-30)
        # The two previous Givens rotations applied to the new column.
        delta = g1 * alpha - g0 * s1 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        # The new rotation, annihilating beta_new.
        rho1c = _floor(rho1)
        g_new = delta / rho1c
        s_new = beta_new / rho1c
        w_new = (v - rho3 * w2 - rho2 * w1) / rho1c
        x = x + g_new * eta * w_new
        eta_new = -s_new * eta
        carry = (x, v, v_next, beta_new, eta_new, g1, g_new, s1, s_new,
                 w1, w_new)
        return carry, eta_new.abs()

    one = torch.ones((), dtype=b.dtype, device=b.device)
    snil = torch.zeros((), dtype=b.dtype, device=b.device)
    carry0 = (x, zero, v, snil, beta1, one, one, snil, snil, zero, zero)
    return _while_solve(step, carry0, b, num_iters, tol)


def _random_block(n: int, k: int, device) -> torch.Tensor:
    """LOBPCG's first search direction: a standard normal (n, k) block
    from a CPU ``torch.Generator`` seeded 7 (the JAX function draws from
    ``jax.random.PRNGKey(7)``, a stream torch cannot reproduce), the same
    on every device."""
    g = torch.Generator().manual_seed(7)
    return torch.randn(n, k, generator=g, dtype=torch.float32).to(device)


def lobpcg(matrix, X0: torch.Tensor, num_iters: int = 40, *,
           m: Optional[Callable] = None, spmm: Optional[Callable] = None,
           largest: bool = False):
    """LOBPCG (Knyazev): k extremal eigenpairs of symmetric A,
    preconditioned.

    Each step: two SpMMs over the block (by default the SELL operator's
    k-column launches: k and 3k columns), one tall-skinny QR and one
    (3k, 3k) dense eigenproblem, and the optional preconditioner ``m``
    (block-capable appliers, e.g. the AMG factory, take the whole (n, k)
    residual block in one call; others are applied per column). ``X0`` is
    the (n, k) initial block. Runs ``num_iters`` steps. Returns
    ``(theta, X, res)``: Ritz values (k,) ascending (descending for
    ``largest``), the eigenvector block (n, k), and per-step residual
    norms (num_iters, k).
    """
    spmm = _default_spmm(spmm)
    n, k = X0.shape

    def a_mul(X):
        return spmm(matrix, X)

    q0, _ = torch.linalg.qr(X0.float())
    theta = torch.sum(q0 * a_mul(q0), dim=0)
    # P starts as a random block independent of X, so the first
    # Rayleigh-Ritz searches span[X, W, P] at full rank.
    P = torch.linalg.qr(_random_block(n, k, X0.device))[0]
    X = q0
    res = torch.zeros(num_iters, k, dtype=torch.float32, device=X0.device)
    for it in range(num_iters):
        AX = a_mul(X)
        R = AX - X * theta[None, :]
        res[it] = torch.linalg.vector_norm(R, dim=0)
        W = _precond_block(m, R)
        S = torch.cat([X, W, P], dim=1)  # (n, 3k)
        Q, _ = torch.linalg.qr(S)
        AQ = a_mul(Q)
        T = Q.T @ AQ
        T = (T + T.T) * 0.5
        evals, C = torch.linalg.eigh(T)  # ascending
        if largest:
            Ck, theta = C[:, -k:].flip(1), evals[-k:].flip(0)
        else:
            Ck, theta = C[:, :k], evals[:k]
        X = Q @ Ck
        # The locally optimal direction: the W and P part of the new
        # block, renormalized so the next basis stays well conditioned.
        P = Q[:, k:] @ Ck[k:, :]
        P = P / (torch.linalg.vector_norm(P, dim=0, keepdim=True) + 1e-30)
    return theta, X, res


def gmres(matrix, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          restart: int = 20, num_restarts: int = 5,
          spmv: Optional[Callable] = None, tol: Optional[float] = None):
    """Solve A x = b for general (nonsymmetric) A by restarted GMRES(m).

    Arnoldi with modified Gram-Schmidt over m = ``restart`` steps, then
    the small (m+1, m) least-squares problem by the pseudo-inverse: an SVD
    whose cutoff, eps·max(m+1, m) of the largest singular value, is that
    of ``jnp.linalg.lstsq(rcond=None)`` (H loses rank at a happy
    breakdown). Returns ``(x, residual_norm_per_restart)``; ``tol`` is
    checked at the restart boundaries.
    """
    spmv = _default_spmv(spmv)
    n = b.shape[0]
    m = restart

    def cycle(carry):
        (x,) = carry
        r = b - spmv(matrix, x)
        beta = _norm(r)
        V = torch.zeros(m + 1, n, dtype=b.dtype, device=b.device)
        V[0] = r / torch.clamp(beta, min=1e-30)
        H = torch.zeros(m + 1, m, dtype=b.dtype, device=b.device)
        for j in range(m):
            w = spmv(matrix, V[j])
            # Modified Gram-Schmidt against the rows filled so far (the
            # JAX loop's masked projections onto the zero rows are no-ops).
            for i in range(j + 1):
                h = torch.vdot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hnorm = _norm(w)
            H[j + 1, j] = hnorm
            V[j + 1] = w / torch.clamp(hnorm, min=1e-30)
        e1 = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        y = torch.linalg.pinv(H) @ e1
        x = x + V[:m].T @ y
        return (x,), _norm(b - spmv(matrix, x))

    x = torch.zeros_like(b) if x0 is None else x0
    return _while_solve(cycle, (x,), b, num_restarts, tol)


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
    rz = torch.vdot(r, z)

    def step(carry):
        x, r, z, p, rz = carry
        ap = spmv(matrix, p)
        alpha = rz / _floor(torch.vdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.vdot(r, z)
        beta = rz_new / _floor(rz)
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


def jacobi_preconditioner(matrix, diag: torch.Tensor, order: int = 3,
                          spmv: Optional[Callable] = None) -> Callable:
    """Truncated-Neumann (fixed-count Jacobi) preconditioner factory:
    ``apply(r) = Σ_{k<order} (I − D⁻¹A)^k D⁻¹ r``, ``order`` Jacobi sweeps
    from zero, the same linear polynomial on every apply. Use an odd
    order: an even one makes M⁻¹ indefinite wherever λ(D⁻¹A) exceeds a
    root of the polynomial (order 2: λ > 2), and warns."""
    if order % 2 == 0:
        warnings.warn(
            "jacobi_preconditioner: even order gives an indefinite "
            "preconditioner whenever lambda_max(D^-1 A) exceeds a root "
            "of the Neumann polynomial (order 2: >2); use an odd order "
            "unless the system is diagonally dominant",
            stacklevel=2,
        )

    def apply(r: torch.Tensor) -> torch.Tensor:
        return jacobi(matrix, r, diag, num_iters=order, spmv=spmv)

    return apply


def chebyshev_preconditioner(matrix, lambda_min: float, lambda_max: float,
                             degree: int = 4,
                             spmv: Optional[Callable] = None) -> Callable:
    """Chebyshev polynomial preconditioner factory: a fixed-degree
    Chebyshev semi-iteration approximating A⁻¹ on [lambda_min,
    lambda_max] (``degree`` SpMVs and AXPYs an apply, no inner
    products), a constant linear operator as CG requires."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        z, _ = chebyshev(matrix, r, lambda_min, lambda_max,
                         num_iters=degree, spmv=spmv)
        return z

    return apply


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

    spmv_l, spmv_lt = _factor_spmvs(spmv, op_builder, factors.strict,
                                    factors.strict_t)

    def apply(r: torch.Tensor) -> torch.Tensor:
        z = trisolve_neumann(factors.strict, factors.diag, r, sweeps=sweeps,
                             spmv=spmv_l)
        return trisolve_neumann(factors.strict_t, factors.diag, z,
                                sweeps=sweeps, spmv=spmv_lt)

    return apply


def _factor_spmvs(spmv, op_builder, first, second):
    """The SpMVs of two triangular parts: their own operators from
    ``op_builder``, or ``spmv`` applied to each."""
    if op_builder is None:
        return spmv, spmv
    op_1, op_2 = op_builder(first), op_builder(second)
    return (lambda _m, z: op_1(z)), (lambda _m, z: op_2(z))


def ilu_preconditioner(factors, sweeps: int = 4,
                       spmv: Optional[Callable] = None,
                       op_builder: Optional[Callable] = None) -> Callable:
    """ILU(0) preconditioner factory: ``apply(r) ≈ (L·U)⁻¹ r`` by two
    fixed-sweep truncated-Neumann triangular solves (unit L, then U with
    ``u_diag``). For general square systems with :func:`bicgstab` or
    :func:`gmres` (the composite apply is not symmetric). ``op_builder``
    as in :func:`ic0_preconditioner`."""
    from smvp_toolkit_tpu_torch.ops.ilu import trisolve_neumann

    spmv_l, spmv_u = _factor_spmvs(spmv, op_builder, factors.l_strict,
                                   factors.u_strict)

    def apply(r: torch.Tensor) -> torch.Tensor:
        z = trisolve_neumann(factors.l_strict, None, r, sweeps=sweeps,
                             spmv=spmv_l)
        return trisolve_neumann(factors.u_strict, factors.u_diag, z,
                                sweeps=sweeps, spmv=spmv_u)

    return apply


def ssor_preconditioner(matrix, omega: float = 1.0, sweeps: int = 4,
                        op_builder: Optional[Callable] = None,
                        spmv: Optional[Callable] = None) -> Callable:
    """SSOR preconditioner factory: ``M = (D+ωL)D⁻¹(D+ωU)/(ω(2−ω))``.

    No factorization: the triangular parts are submatrices of A
    (``ops.ilu.split_triangular``), applied by the fixed-sweep
    truncated-Neumann solves of :func:`ic0_preconditioner`. For symmetric
    A with equal sweep counts the composite is symmetric, and positive
    definite whenever diag(A) > 0. ``omega`` in (0, 2); 1 is symmetric
    Gauss-Seidel. A zero diagonal entry is patched to 1.
    """
    if not 0.0 < omega < 2.0:
        raise ValueError(f"ssor needs 0 < omega < 2, got {omega}")
    from smvp_toolkit_tpu_torch.ops.ilu import (
        split_triangular,
        trisolve_neumann,
    )

    low, d, up = split_triangular(matrix)
    if omega != 1.0:
        low = dataclasses.replace(low, vals=low.vals * omega)
        up = dataclasses.replace(up, vals=up.vals * omega)
    d = torch.where(d.abs() > 1e-30, d, torch.ones_like(d))
    scale = omega * (2.0 - omega)
    spmv_l, spmv_u = _factor_spmvs(spmv, op_builder, low, up)

    def apply(r: torch.Tensor) -> torch.Tensor:
        y = trisolve_neumann(low, d, r, sweeps=sweeps, spmv=spmv_l)
        w = trisolve_neumann(up, d, d * y, sweeps=sweeps, spmv=spmv_u)
        return scale * w

    return apply


def _invert_blocks(blocks: np.ndarray, scale: float) -> np.ndarray:
    """Batched inverse of the (nb, b, b) diagonal blocks; only the blocks
    that are numerically singular are ridged (an escalating diagonal
    shift from 1e-6 of the matrix scale, nine steps of 10x), with a
    warning. Raises ValueError if a block stays singular."""

    def inv(bl):
        try:
            with np.errstate(all="ignore"):
                cand = np.linalg.inv(bl)
        except np.linalg.LinAlgError:
            return None
        return cand if np.isfinite(cand).all() else None

    binv = inv(blocks)
    if binv is not None:
        return binv
    eye = np.eye(blocks.shape[1])
    binv = np.empty_like(blocks)
    bad = []
    for bi in range(blocks.shape[0]):
        inv_b = inv(blocks[bi])
        if inv_b is None:
            bad.append(bi)
        else:
            binv[bi] = inv_b
    max_ridge = 0.0
    for bi in bad:
        ridge, inv_b = scale * 1e-6, None
        for _ in range(9):
            inv_b = inv(blocks[bi] + ridge * eye)
            if inv_b is not None:
                break
            ridge *= 10.0
        if inv_b is None:
            raise ValueError(
                "block_jacobi: a diagonal block remained singular "
                "under the ridge ladder — the diagonal blocks of "
                "this matrix are degenerate"
            )
        binv[bi] = inv_b
        max_ridge = max(max_ridge, ridge)
    warnings.warn(
        f"block_jacobi: {len(bad)} singular diagonal block(s); "
        f"ridged with up to {max_ridge:g} to invert — the "
        "preconditioner is weakened on those blocks only",
        stacklevel=3,
    )
    return binv


def block_jacobi_preconditioner(matrix, block: int = 64) -> Callable:
    """Block-Jacobi factory: ``M = blockdiag(A₁₁, A₂₂, …)``, dense blocks.

    The diagonal blocks are taken on the host and inverted once as a
    batched float64 ``(nb, block, block)`` inverse; every apply is one
    batched mat-vec on the device (``torch.bmm``, a dense product outside
    any sparse kernel). Rows with no entry inside their diagonal block
    (the last block's padding rows, a structurally missing diagonal)
    become identity rows; only numerically singular blocks are ridged.
    For symmetric A the apply is symmetric, CG-safe when the blocks are
    positive definite.
    """
    from smvp_toolkit_tpu_torch.ops.ilu import _csr_host

    n, m = matrix.shape
    if n != m:
        raise ValueError(
            f"block_jacobi needs a square matrix, got {matrix.shape}"
        )
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    block = min(block, n)
    rp, ci, v = _csr_host(matrix)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    nb = -(-n // block)
    blocks = np.zeros((nb, block, block), np.float64)
    same = (rows // block) == (ci // block)
    blocks[rows[same] // block, rows[same] % block, ci[same] % block] = (
        v[same]
    )
    empty_r, empty_c = np.nonzero(~blocks.any(axis=2))
    blocks[empty_r, empty_c, empty_c] = 1.0
    scale = float(np.max(np.abs(v))) if v.size else 1.0
    binv = _invert_blocks(blocks, scale)
    binv_dev = torch.from_numpy(binv.astype(np.float32)).to(
        matrix.dtype).to(matrix.device)
    pad = nb * block - n

    def apply(r: torch.Tensor) -> torch.Tensor:
        rb = torch.nn.functional.pad(r, (0, pad)).reshape(nb, block, 1)
        return torch.bmm(binv_dev, rb).reshape(-1)[:n]

    return apply


def refine_solve(matrix, b, *, inner: Callable, num_refinements: int = 3,
                 vals_lo: Optional[torch.Tensor] = None):
    """Mixed-precision iterative refinement: float64-quality solves from a
    float32 inner solver.

    Wilkinson refinement with the double-float machinery of
    ``ops.precision``: x lives as a (hi, lo) float32 pair, the residual
    ``r = b − A·x`` comes from the double-float CSR SpMV
    (``spmv_csr_df64``, float64 products and row sums), ANY float32 inner
    solver supplies the correction ``d ≈ A⁻¹r`` and ``x += d`` accumulates
    error-free. Each sweep multiplies the error by the inner solve's
    contraction, down to the double-float floor. ``vals_lo`` carries the
    low words of float64 matrix values (``df_split``, aligned with
    ``matrix.vals``) when the operator itself exceeds float32.

    ``inner(r) -> d`` takes and returns float32 vectors on the matrix's
    device; ``b`` may be float32 or float64, a tensor or host array.
    Returns ``(x_hi, x_lo, res_norms)``: the pair and one float64 residual
    norm per sweep, taken before its correction (numpy, length
    ``num_refinements``).
    """
    from smvp_toolkit_tpu_torch.ops.precision import (
        _df_add,
        df_split,
        df_to_f64,
        spmv_csr_df64,
    )

    if isinstance(b, torch.Tensor):
        b = b.detach().to(matrix.device)
    b_hi, b_lo = df_split(b, device=matrix.device)
    x_hi = torch.zeros_like(b_hi)
    x_lo = torch.zeros_like(b_hi)
    norms = []
    for _ in range(num_refinements):
        y_hi, y_lo = spmv_csr_df64(matrix, x_hi, x_lo, vals_lo)
        r_hi, r_lo = _df_add((b_hi, b_lo), (-y_hi, -y_lo))
        norms.append(float(np.linalg.norm(df_to_f64(r_hi, r_lo))))
        d = inner(r_hi.float()).float()
        x_hi, x_lo = _df_add((x_hi, x_lo), (d, torch.zeros_like(d)))
    return x_hi, x_lo, np.asarray(norms)
