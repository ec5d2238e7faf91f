"""Fused Chebyshev and IC(0)-preconditioned CG: whole solves in one
launch, on ``sell_chebyshev_kernel`` (K10) and ``sell_pcg_ic0_kernel``
(K11).

Counterpart of the JAX package's ``ops/pcg_fused.py``.

* :func:`fused_chebyshev`: the inner-product-free Krylov method. Its
  scalars depend only on the spectrum bounds, so the host builds the
  coefficient table in float64 and casts it to float32, as the JAX
  package does; each step is one SpMV and three AXPYs.
* :func:`fused_pcg_ic0`: CG preconditioned by IC(0) with fixed-sweep
  truncated-Neumann triangular solves. Each step runs three operators
  back to back, A, then (sweeps−1) sweeps of strict(L), then (sweeps−1)
  of strict(L)ᵀ, from one concatenated plane array: the factor plans are
  planned at A's chunk and put on one tile window with A's plan
  (``sell_plan.common_window``), so the plan arrays equal the JAX ones.

Numerics match ``models.solvers.chebyshev`` and
``models.solvers.pcg_precond(ic0_preconditioner(...))`` up to float32
re-association of the reductions. Both kernels run the merged rel‖slice
word only (a window over 511 tiles raises, as the JAX ``_require_relsl``
does) and a resident-y plan. Their state, four (K10) or seven (K11)
``T·128`` float32 vectors, lives in device memory, with no VMEM budget to
gate the system size.

On a CUDA operator each wrapper launches its kernel or raises; only an
operator on the CPU runs the plain version (``*_plain``), the scan-loop
solver of ``models.solvers`` over the plain SELL sweeps.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import List, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.cg_fused import (
    check_rhs,
    check_square,
    fused_cg,
    launch,
    pad_state,
    plain_spmv,
    state_tiles,
)
from smvp_toolkit_tpu_torch.ops.plan_checks import REL_DEAD, check_plan
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
    common_window,
)

__all__ = [
    "fused_chebyshev",
    "fused_chebyshev_plain",
    "fused_pcg_ic0",
    "fused_pcg_ic0_plain",
    "chebyshev_coefficients",
    "chebyshev_launch",
    "pcg_ic0_launch",
    "ic0_plans",
    "SOLVER_KERNELS",
]


def _require_relsl(op, label: str) -> None:
    if op.plan.y_block_slices:
        raise ValueError(f"{label} requires a resident-y plan")
    if op.base_route != "relsl":
        raise ValueError(f"{label} runs the relsl layout only")


def chebyshev_coefficients(lambda_min: float, lambda_max: float,
                           num_iters: int) -> Tuple[np.ndarray, np.float32]:
    """The (2, num_iters) float32 table of (a_k, c_k), built in float64,
    and float32(1/θ): the JAX package's host-side recurrence."""
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coeffs = np.empty((2, max(num_iters, 1)), dtype=np.float32)
    for k in range(num_iters):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coeffs[0, k] = rho_new * rho           # a_k (d coefficient)
        coeffs[1, k] = 2.0 * rho_new / delta   # c_k (r coefficient)
        rho = rho_new
    return coeffs, np.float32(1.0 / theta)


def _chebyshev_checks(op, b, num_iters) -> int:
    n = check_square(op, "fused_chebyshev")
    check_rhs(op, b)
    if num_iters > 0:
        _require_relsl(op, "fused_chebyshev")
    return n


def fused_chebyshev_plain(op, b: torch.Tensor, lambda_min: float,
                          lambda_max: float, num_iters: int) -> torch.Tensor:
    """K10's function in plain PyTorch on the operator's device (the
    contract of :func:`fused_chebyshev`): ``models.solvers.chebyshev`` on
    the padded state over the plain SELL sweep. Its scalars round to the
    same float32 (a_k, c_k); its first direction is b/θ where the kernel's
    is b·float32(1/θ), a last-bit difference."""
    from smvp_toolkit_tpu_torch.models.solvers import chebyshev

    n = _chebyshev_checks(op, b, num_iters)
    if num_iters <= 0:
        return torch.zeros(n, dtype=torch.float32, device=op.device)
    x, _ = chebyshev(op._planes(), pad_state(b, state_tiles(op.plan)),
                     lambda_min, lambda_max, num_iters=num_iters,
                     spmv=plain_spmv(op))
    return x[:n]


def fused_chebyshev(op, b: torch.Tensor, lambda_min: float,
                    lambda_max: float, num_iters: int) -> torch.Tensor:
    """Chebyshev iteration for SPD A in ONE launch of
    ``sell_chebyshev_kernel``; returns x (float32, ``nrows``).

    Per step: q = A·d; x += d; r −= q; d = a_k·d + c_k·r, with x0 = 0,
    r0 = b, d0 = b·float32(1/θ). ``num_iters <= 0`` returns zeros.
    """
    n = _chebyshev_checks(op, b, num_iters)
    if num_iters <= 0:
        return torch.zeros(n, dtype=torch.float32, device=op.device)
    if op.device.type == "cpu":
        return fused_chebyshev_plain(op, b, lambda_min, lambda_max,
                                     num_iters)
    x = chebyshev_launch(op, b, lambda_min, lambda_max, num_iters)
    fused_chebyshev.launches += 1
    return x[:n]


def chebyshev_launch(op, b: torch.Tensor, lambda_min: float,
                     lambda_max: float, num_iters: int,
                     variant=None) -> torch.Tensor:
    """One launch of ``sell_chebyshev_kernel`` on a CUDA operator (checked
    by the caller, ``num_iters >= 1``), or of a variant of it
    (``cg_fused.launch``'s ``variant``); x on the padded state (T·128)."""
    coeffs, inv_theta = chebyshev_coefficients(lambda_min, lambda_max,
                                               num_iters)
    coef = torch.from_numpy(np.ascontiguousarray(coeffs.T)).to(op.device)
    bt = pad_state(b, state_tiles(op.plan))
    x, r, d, q = (torch.empty_like(bt) for _ in range(4))
    xin = d if op.value_dtype == torch.float32 else torch.empty(
        bt.numel(), dtype=op.value_dtype, device=op.device)
    launch("sell_chebyshev_kernel", op, route="relsl",
           planes=dict(vals=op.vals, lidx=op.lidx, relsl=op.relsl,
                       tile_base=op.tile_base),
           b=bt, x=x, r=r, p=d, q=q, xin=xin, iterations=num_iters,
           coef=coef, inv_theta=float(inv_theta), variant=variant)
    return x


# ---------------------------------------------------------------------------
# IC(0)-PCG
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _IC0Planes:
    """The three common-window plans and their concatenated device planes
    (A, strict(L), strict(L)ᵀ), with the sublane ranges of each."""

    plans: Tuple[SellPlan, SellPlan, SellPlan]
    window_tiles: int
    vals: torch.Tensor
    lidx: torch.Tensor
    relsl: torch.Tensor
    tile_base: torch.Tensor
    invd: torch.Tensor  # 1 / diag(L), float32, padded to T·128
    sublane_bounds: Tuple[int, int, int, int]

    def sub_planes(self, k: int, chunk: int):
        """Plan k's planes, as the plain sweep takes them."""
        lo, hi = self.sublane_bounds[k], self.sublane_bounds[k + 1]
        return (self.vals[lo:hi], self.lidx[lo:hi], self.relsl[lo:hi],
                self.tile_base[lo // chunk:hi // chunk])


def ic0_plans(op, factors) -> Tuple[List[SellPlan], int, int, list]:
    """A's plan and the two factor plans on one window, as the JAX
    ``fused_pcg_ic0`` builds them: strict(L) and strict(L)ᵀ planned at
    A's chunk with ``allow_small_chunk=False``, then
    ``common_window([A, L, Lᵀ], NS)``. Returns ``(plans, WT, NSW,
    slice_bases)``."""
    n, m = op.shape
    chunk = op.plan.chunk

    def factor_plan(csr):
        r, c, v, _ = S._triplets_from_csr_host(csr)
        return build_sell_plan(np.asarray(r, np.int64), np.asarray(c, np.int64),
                               v, (n, m), chunk=chunk,
                               allow_small_chunk=False)

    return common_window(
        [op.plan, factor_plan(factors.strict), factor_plan(factors.strict_t)],
        op.plan.n_slices)


def _ic0_planes(op, factors) -> _IC0Planes:
    """The fused IC(0) planes of (op, factors), planned and uploaded once
    and kept on the operator, keyed weakly by the factors."""
    cache = op.__dict__.setdefault("_ic0_planes", weakref.WeakKeyDictionary())
    got = cache.get(factors)
    if got is not None:
        return got
    plans, wt, _, _ = ic0_plans(op, factors)
    if wt > REL_DEAD:
        raise ValueError("common window too wide for the relsl layout")
    for p in plans:
        check_plan(p)
    dev, chunk = op.device, op.plan.chunk
    t_tiles = max(state_tiles(p) for p in plans)
    dh = factors.diag.float().cpu().numpy()
    invd = np.zeros(t_tiles * LANES, dtype=np.float32)
    invd[: len(dh)] = 1.0 / dh
    bounds = np.cumsum([0] + [p.n_sublanes for p in plans])

    def cat(arrays, np_dtype):
        return host_tensor(np.concatenate([np.asarray(a).reshape(-1) for a in
                                           arrays]), np_dtype)

    got = _IC0Planes(
        plans=tuple(plans), window_tiles=wt,
        vals=cat([p.vals for p in plans], np.float32).reshape(-1, LANES).to(
            op.value_dtype).to(dev),
        lidx=cat([p.lane_idx for p in plans], np.int32).reshape(
            -1, LANES).to(S.lidx_dtype(chunk)).to(dev),
        relsl=cat([S.relsl_plane_host(p) for p in plans], np.int32).to(dev),
        tile_base=cat([p.tile_base for p in plans], np.int32).to(dev),
        invd=torch.from_numpy(invd).to(dev),
        sublane_bounds=tuple(int(s) for s in bounds),
    )
    cache[factors] = got
    return got


def _pcg_ic0_checks(op, factors, b, sweeps) -> int:
    if sweeps < 2:
        raise ValueError(
            "fused_pcg_ic0 needs sweeps >= 2 (sweeps=1 is plain Jacobi "
            "scaling — use models.solvers.pcg)"
        )
    n = check_square(op, "fused_pcg_ic0")
    _require_relsl(op, "fused_pcg_ic0")
    check_rhs(op, b)
    if factors.shape != op.shape:
        raise ValueError(f"factors of shape {factors.shape} for a "
                         f"{op.shape} operator")
    return n


def fused_pcg_ic0_plain(op, factors, b: torch.Tensor, num_iters: int,
                        sweeps: int = 4) -> torch.Tensor:
    """K11's function in plain PyTorch on the operator's device (the
    contract of :func:`fused_pcg_ic0`): ``models.solvers.pcg_precond``
    with the two Neumann solves of ``ic0_preconditioner``, on the padded
    state over the plain sweeps of the three common-window plans."""
    from smvp_toolkit_tpu_torch.models.solvers import pcg_precond
    from smvp_toolkit_tpu_torch.ops.ilu import trisolve_neumann

    n = _pcg_ic0_checks(op, factors, b, sweeps)
    fp = _ic0_planes(op, factors)
    if num_iters <= 0:
        return torch.zeros(n, dtype=torch.float32, device=op.device)
    pa, pl, plt = (fp.sub_planes(k, op.plan.chunk) for k in range(3))
    spmv = plain_spmv(op)
    # diag(L) on the state; padding rows take 1 (r and every sweep are 0
    # there), so 1 / diag is the kernel's invd on every live row.
    diag = torch.ones_like(fp.invd)
    diag[:n] = factors.diag.to(diag)

    def precond(r):
        z = trisolve_neumann(pl, diag, r, sweeps=sweeps, spmv=spmv)
        return trisolve_neumann(plt, diag, z, sweeps=sweeps, spmv=spmv)

    x, _ = pcg_precond(pa, pad_state(b, len(fp.invd) // LANES), precond,
                       num_iters=num_iters, spmv=spmv)
    return x[:n]


def fused_pcg_ic0(op, factors, b: torch.Tensor, num_iters: int,
                  sweeps: int = 4) -> torch.Tensor:
    """IC(0)-preconditioned CG in ONE launch of ``sell_pcg_ic0_kernel``;
    returns x (float32, ``nrows``).

    ``factors`` is ``ops.ilu.ic0``'s result. Pass 0 sets up z0 = M⁻¹b and
    p = z0; each of the ``num_iters`` steps is one CG step preconditioned
    by ``sweeps`` Neumann sweeps per triangle. The factor plans are
    planned and uploaded at the first call for these factors and kept on
    the operator. ``num_iters <= 0`` returns zeros.

    The kernel runs its A, strict(L) and strict(L)ᵀ phases on the
    warp-per-sublane body, each over its plan's work items: planes or q
    not aligned for its vector loads raise "misaligned address", planes
    that are not whole chunks, or factor bounds off a chunk boundary,
    "invalid argument"; nothing falls back.
    """
    n = _pcg_ic0_checks(op, factors, b, sweeps)
    if num_iters <= 0:
        return torch.zeros(n, dtype=torch.float32, device=op.device)
    if op.device.type == "cpu":
        return fused_pcg_ic0_plain(op, factors, b, num_iters, sweeps)
    x = pcg_ic0_launch(op, factors, b, num_iters, sweeps)
    fused_pcg_ic0.launches += 1
    return x[:n]


def pcg_ic0_launch(op, factors, b: torch.Tensor, num_iters: int,
                   sweeps: int, variant=None) -> torch.Tensor:
    """One launch of ``sell_pcg_ic0_kernel`` on a CUDA operator (checked
    by the caller, ``num_iters >= 1``), or of a variant of it
    (``cg_fused.launch``'s ``variant``); x on the padded state (T·128)."""
    fp = _ic0_planes(op, factors)
    bt = pad_state(b, len(fp.invd) // LANES)
    x, r, p, q, z = (torch.empty_like(bt) for _ in range(5))
    xin = torch.empty(bt.numel(), dtype=op.value_dtype, device=op.device)
    s_a, s_l = fp.sublane_bounds[1], fp.sublane_bounds[2]
    launch("sell_pcg_ic0_kernel", op, route="relsl",
           planes=dict(vals=fp.vals, lidx=fp.lidx, relsl=fp.relsl,
                       tile_base=fp.tile_base),
           b=bt, x=x, r=r, p=p, q=q, xin=xin, iterations=num_iters,
           invd=fp.invd, z=z, slots_l0=s_a * LANES, slots_lt0=s_l * LANES,
           sweeps=sweeps, variant=variant)
    return x


for _fn, _name in ((fused_chebyshev, "sell_chebyshev_kernel"),
                   (fused_pcg_ic0, "sell_pcg_ic0_kernel")):
    _fn.launches = 0
    _fn.kernel = _name

# Every solver kernel's wrapper by kernel name, each with its launch count.
SOLVER_KERNELS = {f.kernel: f for f in (fused_cg, fused_chebyshev,
                                        fused_pcg_ic0)}
