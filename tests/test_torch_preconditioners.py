"""The port's preconditioner factories (``models/solvers.py``) against the
JAX package's: truncated Neumann (``jacobi_preconditioner``), the
Chebyshev polynomial, ILU(0), SSOR and block Jacobi.

The same numpy-seeded r goes through each apply of both packages: within
1e-6 of max |z| (float32 SpMVs and products in other summation orders);
the Chebyshev polynomial, itself a fixed-count Chebyshev solve whose
wide interval amplifies rounding, within the solves' 1e-4.
Block Jacobi's inverse blocks, taken on the host in float64 and stored in
float32, are held bit for bit to the JAX ones, with the ridge ladder on
singular blocks only, the identity rows of empty diagonal rows and the
same warning. Each factory then preconditions a fixed-count solve (PCG
on Poisson 16²; BiCGSTAB right-preconditioned by ILU(0) on the upwind
convection matrix): x within 1e-4 of max |x| of the JAX solve; and
BiCGSTAB-ILU(0) on Poisson 24² stops at 1e-6 within one step of it. On the
port each apply runs its triangular parts through the factor operators
(``op_builder``, the SELL operator's plain version on the CPU) or the
default SpMV, as the CLI runs them.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu import models as jm
from smvp_toolkit_tpu.ops import ilu as jilu
from smvp_toolkit_tpu.ops.algebra import diagonal as jdiagonal
from smvp_toolkit_tpu_torch.models import solvers as tm
from smvp_toolkit_tpu_torch.ops import ilu as tilu
from smvp_toolkit_tpu_torch.ops import spmv_sell
from smvp_toolkit_tpu_torch.ops.algebra import diagonal
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

from torch_systems import (
    TOL_X,
    convection,
    pair,
    rel,
    same_bits,
    stop_step,
)

TOL_APPLY = 1e-6
SYSTEMS = {
    "poisson16": lambda: poisson2d(16),
    "hpcg6": lambda: hpcg_stencil(6),
    "convection16": convection,
}


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def system(request):
    jcoo, jcsr, tcoo, tcsr = pair(SYSTEMS[request.param]())
    r = np.random.default_rng(3).standard_normal(tcsr.shape[0]).astype(
        np.float32)
    return dict(name=request.param, jcoo=jcoo, jcsr=jcsr, tcoo=tcoo,
                tcsr=tcsr, r=r)


def _applies(tpre, jpre, r):
    z_t = tpre(torch.from_numpy(r)).numpy()
    z_j = np.asarray(jpre(jnp.asarray(r)))
    assert z_t.shape == z_j.shape and z_t.dtype == np.float32
    return rel(z_t, z_j)


@pytest.mark.parametrize("order", [1, 3])
def test_neumann_apply(system, order):
    s = system
    tpre = tm.jacobi_preconditioner(s["tcsr"], diagonal(s["tcoo"]),
                                    order=order)
    jpre = jm.jacobi_preconditioner(s["jcsr"], jdiagonal(s["jcoo"]),
                                    order=order)
    assert _applies(tpre, jpre, s["r"]) <= TOL_APPLY


def test_neumann_even_order_warns(system):
    s = system
    with pytest.warns(UserWarning, match="even order"):
        tm.jacobi_preconditioner(s["tcsr"], diagonal(s["tcoo"]), order=2)


@pytest.mark.parametrize("degree", [2, 8])
def test_chebyshev_apply(system, degree):
    s = system
    lam = np.linalg.eigvals(sp.coo_matrix(
        SYSTEMS[s["name"]]()).toarray()).real
    lo, hi = 0.3 * float(lam.min()), 1.1 * float(lam.max())
    tpre = tm.chebyshev_preconditioner(s["tcsr"], lo, hi, degree=degree)
    jpre = jm.chebyshev_preconditioner(s["jcsr"], lo, hi, degree=degree)
    assert _applies(tpre, jpre, s["r"]) <= TOL_X


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("factor_ops", [False, True])
def test_ilu_apply(system, sweeps, factor_ops):
    s = system
    kw = {"op_builder": spmv_sell.sell_op_csr} if factor_ops else {}
    tpre = tm.ilu_preconditioner(tilu.ilu0(s["tcsr"]), sweeps=sweeps, **kw)
    jpre = jm.ilu_preconditioner(jilu.ilu0(s["jcsr"]), sweeps=sweeps)
    assert _applies(tpre, jpre, s["r"]) <= TOL_APPLY


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("factor_ops", [False, True])
def test_ssor_apply(system, omega, factor_ops):
    s = system
    kw = {"op_builder": spmv_sell.sell_op_csr} if factor_ops else {}
    tpre = tm.ssor_preconditioner(s["tcsr"], omega=omega, sweeps=4, **kw)
    jpre = jm.ssor_preconditioner(s["jcsr"], omega=omega, sweeps=4)
    assert _applies(tpre, jpre, s["r"]) <= TOL_APPLY


def test_ssor_refuses_omega_out_of_range(system):
    for omega in (0.0, 2.0):
        with pytest.raises(ValueError, match="omega"):
            tm.ssor_preconditioner(system["tcsr"], omega=omega)


def _closure(fn, name):
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells[name]


def _caught(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


@pytest.mark.parametrize("block", [1, 7, 64])
def test_block_jacobi_inverse_blocks_equal_jax(system, block):
    s = system
    tpre = tm.block_jacobi_preconditioner(s["tcsr"], block=block)
    jpre = jm.block_jacobi_preconditioner(s["jcsr"], block=block)
    assert same_bits(_closure(tpre, "binv_dev").numpy(),
                     _closure(jpre, "binv_dev"))
    assert _applies(tpre, jpre, s["r"]) <= TOL_APPLY


def _singular_blocks():
    """Poisson 8² with its first 8-row block made singular (rows 0 and 1
    equal there) and row 20's entries removed (an empty diagonal row)."""
    a = poisson2d(8).toarray()
    a[1, :8] = a[0, :8]
    a[20, :] = 0.0
    return sp.coo_matrix(a)


def test_block_jacobi_ridges_only_singular_blocks():
    _, jcsr, _, tcsr = pair(_singular_blocks())
    tpre, twarn = _caught(lambda: tm.block_jacobi_preconditioner(tcsr,
                                                                 block=8))
    jpre, jwarn = _caught(lambda: jm.block_jacobi_preconditioner(jcsr,
                                                                 block=8))
    assert twarn == jwarn and len(twarn) == 1
    assert "1 singular diagonal block" in twarn[0]
    tb = _closure(tpre, "binv_dev").numpy()
    assert same_bits(tb, _closure(jpre, "binv_dev"))
    assert tb[2, 4, 4] == 1.0 and not tb[2, 4, np.arange(8) != 4].any()


def test_block_jacobi_refuses_rectangular_and_bad_block(system):
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.interop import coo_from_triplets

    rect = csr_encode(coo_from_triplets(np.array([0]), np.array([2]),
                                        np.array([1.0]), (2, 3),
                                        device="cpu"))
    with pytest.raises(ValueError, match="square"):
        tm.block_jacobi_preconditioner(rect)
    with pytest.raises(ValueError, match="positive"):
        tm.block_jacobi_preconditioner(system["tcsr"], block=0)


def _factories(which, tcsr, jcsr, tcoo, jcoo):
    if which == "neumann":
        return (tm.jacobi_preconditioner(tcsr, diagonal(tcoo), order=3),
                jm.jacobi_preconditioner(jcsr, jdiagonal(jcoo), order=3))
    if which == "chebyshev":
        return (tm.chebyshev_preconditioner(tcsr, 0.02, 8.8, degree=8),
                jm.chebyshev_preconditioner(jcsr, 0.02, 8.8, degree=8))
    if which == "ssor":
        return (tm.ssor_preconditioner(tcsr,
                                       op_builder=spmv_sell.sell_op_csr),
                jm.ssor_preconditioner(jcsr))
    return (tm.block_jacobi_preconditioner(tcsr, block=16),
            jm.block_jacobi_preconditioner(jcsr, block=16))


@pytest.mark.parametrize("which", ["neumann", "chebyshev", "ssor", "bjac"])
def test_pcg_with_each_factory_matches_jax(which):
    jcoo, jcsr, tcoo, tcsr = pair(poisson2d(16))
    b = np.random.RandomState(0).randn(256).astype(np.float32)
    tpre, jpre = _factories(which, tcsr, jcsr, tcoo, jcoo)
    tx, tres = tm.pcg_precond(tcsr, torch.from_numpy(b), tpre, num_iters=12)
    jx, jres = jm.pcg_precond(jcsr, jnp.asarray(b), jpre, num_iters=12)
    assert rel(tx.numpy(), jx) <= TOL_X
    assert rel(tres.numpy(), jres) <= TOL_X


def test_bicgstab_right_preconditioned_by_ilu_matches_jax():
    """On the convection matrix x after 4 steps (BiCGSTAB's residual there
    jumps 25-fold at its sixth step, where last-bit differences grow to
    percents, and its stop at 1e-6 comes after 34-38 steps, past the range
    where rounding decides it: tests/test_torch_krylov.py); on Poisson 24²,
    where it stops within 16 steps, the stopping step at 1e-6 within one of
    the JAX solve's."""
    from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr

    for a, iters, tol in ((convection(), 4, None), (poisson2d(24), 60, 1e-6)):
        _, jcsr, _, tcsr = pair(a)
        b = np.random.RandomState(1).randn(a.shape[0]).astype(np.float32)
        t_apply = tm.ilu_preconditioner(tilu.ilu0(tcsr),
                                        op_builder=spmv_sell.sell_op_csr)
        j_apply = jm.ilu_preconditioner(jilu.ilu0(jcsr))

        def t_spmv(m, v):
            return spmv_sell.spmv_csr_sell(m, t_apply(v))

        def j_spmv(m, v):
            return spmv_csr(m, j_apply(v))

        tu, tres = tm.bicgstab(tcsr, torch.from_numpy(b), num_iters=iters,
                               spmv=t_spmv, tol=tol)
        ju, jres = jm.bicgstab(jcsr, jnp.asarray(b), num_iters=iters,
                               spmv=j_spmv, tol=tol)
        if tol is None:
            assert rel(t_apply(tu).numpy(), j_apply(ju)) <= TOL_X
        else:
            t_stop = stop_step(tres.numpy(), b, tol)
            j_stop = stop_step(jres, b, tol)
            assert j_stop < iters and abs(t_stop - j_stop) <= 1
