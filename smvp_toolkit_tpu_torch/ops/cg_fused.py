"""Fused conjugate gradient: the whole fixed-iteration CG solve in one
launch of ``sell_cg_kernel`` (K9).

Counterpart of the JAX package's ``ops/cg_fused.py``. Numerically it is
:func:`~smvp_toolkit_tpu_torch.models.solvers.conjugate_gradient` (float32
state, the same update order and breakdown guards, x0 = 0) up to the
re-association of the reductions:

    q = A·p;  α = r·r / max(p·q, 1e-30);  x += α·p;  r -= α·q
    β = r'·r' / max(r·r, 1e-30);  p = r + β·p

The kernel (``csrc/sell_solvers.cu``) is one cooperative launch: the
SpMV phase walks the plan's work items on the warp-per-sublane body of the
SELL kernels under the operator's route (merged word, ``sell_cg_kernel``,
or split planes, ``sell_cg_split_kernel``), gathering the SpMV input with
coherent loads, and the vector phases and the two reductions per step run
between grid-wide barriers. Planes not aligned for its vector loads (or a
q not aligned to 16 bytes) raise "misaligned address", planes that are
not whole chunks "invalid argument". The state (b, x, r, p, q) lives
in device memory as five ``T·128`` float32 vectors, ``T = max(NS, CT)``;
rows past the matrix stay exactly 0. The JAX kernel keeps that state in
VMEM and refuses systems past about 460k rows unless its VMEM budget is
raised (``SMVP_SELL_VMEM_MB``); the card has no such budget, so this runs
the million-row class at the default settings.

On a CUDA operator :func:`fused_cg` launches the kernel or raises; only an
operator on the CPU runs :func:`fused_cg_plain`, the scan-loop solver over
the route's plain SELL sweep. The helpers here (state padding, the plain
SpMV on the state, the kernel library) serve ``ops/pcg_fused.py`` too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.plan_checks import check_planes
from smvp_toolkit_tpu_torch.ops.sell_plan import LANES, SellPlan
from smvp_toolkit_tpu_torch.utils import tracing
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["cg_launch", "fused_cg", "fused_cg_plain", "solver_blocks"]

_VP = ctypes.c_void_p
_SIGNATURES = {
    "sell_solver_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP, _VP,   # planes
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,      # vectors
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP,
    ]),
    "sell_solver_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# Solver ids of csrc/sell_solvers.cu (its Solver enum).
_SOLVER_IDS = {"cg": 0, "chebyshev": 1, "pcg_ic0": 2}
_SOLVER_OF = {"sell_cg_kernel": "cg", "sell_chebyshev_kernel": "chebyshev",
              "sell_pcg_ic0_kernel": "pcg_ic0"}


def _lib() -> ctypes.CDLL:
    return _build.load("sell_solvers", _SIGNATURES)


def state_tiles(plan: SellPlan) -> int:
    """Tiles of the solver state: rows [0, NS) serve the row space (q, r,
    x), rows [0, CT) the column space the SpMV reads."""
    return max(plan.n_slices, plan.n_coltiles)


def pad_state(v: torch.Tensor, t_tiles: int) -> torch.Tensor:
    """``v`` as float32, zero-padded to ``t_tiles·128`` entries."""
    v = v.reshape(-1)
    out = torch.zeros(t_tiles * LANES, dtype=torch.float32, device=v.device)
    out[: v.shape[0]] = v.float()
    return out


def check_square(op, label: str) -> int:
    n, m = op.shape
    if n != m:
        raise ValueError(f"{label} needs a square (SPD) system")
    if op.plan.y_block_slices:
        raise ValueError(f"{label} requires a resident-y plan")
    return n


def check_rhs(op, b: torch.Tensor) -> None:
    if b.device != op.device:
        raise ValueError(f"b is on {b.device}, the operator on {op.device}")
    if b.dim() != 1 or b.shape[0] > op.shape[0]:
        raise ValueError(f"b must be a vector of at most {op.shape[0]} "
                         f"entries, got shape {tuple(b.shape)}")


def plain_spmv(op):
    """``spmv(planes, v)`` for the ``models.solvers`` functions, the
    solver's "matrix" being the planes it sweeps (the operator's, or a K11
    factor's): q = planes·v on state vectors with the route's plain SELL
    sweep, v's first CT·128 entries rounded to the value dtype (bf16 mode
    rounds the SpMV input, as the kernels do), q zero-padded to v's
    length."""
    plain = getattr(S, op.kernel.__name__ + "_plain")
    kw = op._kw()
    n_in = op.plan.n_coltiles * LANES

    def spmv(planes, v: torch.Tensor) -> torch.Tensor:
        y = plain(*planes, v[:n_in].to(op.value_dtype), **kw)
        q = torch.zeros_like(v)
        q[: y.shape[0]] = y
        return q

    return spmv


def solver_blocks(kernel: str, value_dtype: torch.dtype,
                  lidx_dt: torch.dtype, device=None,
                  route: str = "relsl") -> int:
    """Blocks of one launch of ``kernel`` (``sell_cg_kernel``,
    ``sell_chebyshev_kernel`` or ``sell_pcg_ic0_kernel``) on ``route``
    for these plane types: SMs × co-resident blocks."""
    dev = resolve_device(device)
    lib = _lib()
    out = ctypes.c_int(0)
    rc = lib.sell_solver_blocks(
        _SOLVER_IDS[_SOLVER_OF[kernel]], S._ROUTE_IDS[route],
        int(value_dtype == torch.bfloat16), int(lidx_dt == torch.int32),
        dev.index, ctypes.byref(out))
    S._check_rc(lib, rc, f"{kernel} occupancy query")
    return out.value


def _check_state(n: int, dev, vectors: dict, xin, value_dtype) -> None:
    """The kernels index every state vector up to ``n`` unchecked."""
    for name, t in vectors.items():
        if t is None:
            continue
        if (t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 vector of "
                             f"{n} entries on {dev}")
    if (xin.dtype != value_dtype or xin.numel() != n
            or not xin.is_contiguous() or xin.device != dev):
        raise ValueError(f"the SpMV input must be {value_dtype} of {n} "
                         f"entries on {dev}")


def launch(kernel: str, op, *, route: str, planes: dict, b, x, r, p, q,
           xin, iterations: int, coef=None, invd=None, z=None,
           slots_l0: int = 0, slots_lt0: int = 0, sweeps: int = 0,
           inv_theta: float = 0.0, variant=None) -> None:
    """One cooperative launch of a solver kernel on the operator's device
    and PyTorch's current stream. ``planes`` are as ``check_planes`` takes
    them (``relsl``, or ``rel`` and ``slice_of``); the state vectors hold
    ``T·128`` entries. The reduction arrays are allocated here, sized by
    the kernel's grid. Raises on any CUDA error. ``variant`` = (fn, id):
    call ``fn``, a variant's C launcher with the arguments of
    ``sell_solver_launch``, with ``id`` in place of the solver id
    (``bench/bench_variants.py``)."""
    with tracing.span("solve.launch"):
        dev = op.device
        vals, lidx = planes["vals"], planes["lidx"]
        check_planes(**planes, chunk=op.plan.chunk)
        n = state_tiles(op.plan) * LANES
        _check_state(n, dev, dict(b=b, x=x, r=r, p=p, q=q, z=z, invd=invd),
                     xin, vals.dtype)
        if coef is not None and (coef.numel() < 2 * iterations
                                 or coef.dtype != torch.float32):
            raise ValueError("coef must hold 2 float32 per iteration")
        lib = _lib()
        blocks = solver_blocks(kernel, vals.dtype, lidx.dtype, dev, route)
        part = torch.empty(2 * blocks, dtype=torch.float64, device=dev)
        n_slots = vals.numel()
        meta = planes.get("relsl", planes.get("rel"))
        fn, ident = variant or (lib.sell_solver_launch,
                                _SOLVER_IDS[_SOLVER_OF[kernel]])
        rc = fn(
            ident, S._ROUTE_IDS[route],
            vals.data_ptr(), lidx.data_ptr(), meta.data_ptr(),
            S._ptr(planes.get("slice_of")), planes["tile_base"].data_ptr(),
            b.data_ptr(), S._ptr(coef), S._ptr(invd), x.data_ptr(),
            r.data_ptr(), p.data_ptr(), q.data_ptr(), S._ptr(z),
            xin.data_ptr(), part.data_ptr(), blocks, n_slots, slots_l0 or n_slots,
            slots_lt0 or n_slots, n, op.plan.chunk, iterations, sweeps,
            inv_theta, int(vals.dtype == torch.bfloat16),
            int(lidx.dtype == torch.int32), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        S._check_rc(lib, rc, f"{kernel} cooperative launch")


def _route_planes(op) -> dict:
    planes = dict(vals=op.vals, lidx=op.lidx, tile_base=op.tile_base)
    if op.relsl is not None:
        return dict(planes, relsl=op.relsl)
    return dict(planes, rel=op.rel, slice_of=op.slice_of)


def fused_cg_plain(op, b: torch.Tensor, num_iters: int) -> torch.Tensor:
    """K9's function in plain PyTorch, on the operator's device: the same
    contract as :func:`fused_cg`. It is ``models.solvers.
    conjugate_gradient`` on the padded state over the route's plain SELL
    sweep."""
    from smvp_toolkit_tpu_torch.models.solvers import conjugate_gradient

    n = check_square(op, "fused_cg")
    check_rhs(op, b)
    with tracing.span("solve.prep"):
        bt = pad_state(b, state_tiles(op.plan))
    with tracing.span("solve.launch"):
        x, _ = conjugate_gradient(op._planes(), bt,
                                  num_iters=max(num_iters, 0),
                                  spmv=plain_spmv(op))
    return x[:n]


_CG = {"solver": "cg"}  # the span's attributes, made once


def fused_cg(op, b: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Solve A x = b (A symmetric positive-definite, encoded by ``op``, a
    ``SellSpMV``) with ``num_iters`` CG steps in ONE launch of
    ``sell_cg_kernel``; returns x (float32, ``nrows``).

    The iteration count is fixed; read convergence off a residual
    afterwards. Refuses a rectangular system and a streamed-y plan.
    ``num_iters <= 0`` returns zeros.
    """
    with tracing.span("solve.call", _CG):
        n = check_square(op, "fused_cg")
        check_rhs(op, b)
        if num_iters <= 0:
            return torch.zeros(n, dtype=torch.float32, device=op.device)
        if op.device.type == "cpu":
            return fused_cg_plain(op, b, num_iters)
        x = cg_launch(op, b, num_iters)
        fused_cg.launches += 1
        return x[:n]


def cg_launch(op, b: torch.Tensor, num_iters: int,
              variant=None) -> torch.Tensor:
    """One launch of ``sell_cg_kernel`` on a CUDA operator (checked by the
    caller, ``num_iters >= 1``), or of a variant of it (``launch``'s
    ``variant``); x on the padded state (T·128)."""
    with tracing.span("solve.prep"):
        bt = pad_state(b, state_tiles(op.plan))
        x, r, p, q = (torch.empty_like(bt) for _ in range(4))
        xin = p if op.value_dtype == torch.float32 else torch.empty(
            bt.numel(), dtype=op.value_dtype, device=op.device)
    launch("sell_cg_kernel", op, route=op.base_route,
           planes=_route_planes(op), b=bt, x=x, r=r, p=p, q=q, xin=xin,
           iterations=num_iters, variant=variant)
    return x


fused_cg.launches = 0
fused_cg.kernel = "sell_cg_kernel"
