"""The port's smoothed-aggregation AMG (``models/amg.py``, the
``aggregate_pass`` of ``csrc/amg.cpp``) against the JAX package's
``models/amg.py``.

Host artefacts bit for bit: the aggregates of the port's C++ pass (built
here with the host compiler), of its numpy pass and of the JAX package's
``_aggregate`` (its native library and, under ``SMVP_NATIVE_AMG=0``, its
numpy loop) on the same strength graphs; and every level of
``amg_setup`` (the CSR arrays of A, P and Pᵀ, ``inv_diag``, ``omega``,
``rho``, ``coarse_inv``), with the same refusal where coarsening stalls
(HPCG 17³ has no strong connection at θ = 0.08). The V-cycle apply, with
the Jacobi and the Chebyshev smoother, one and two sweeps and cycles,
agrees with the JAX apply within 1e-5 of max |z| (float32 level operators
summing in other orders through a few levels); the block apply (n, k)
with k single applies within 1e-6. On the port the levels run on their
SELL operators (``op_builder``; plain versions on the CPU) and on the
plain-PyTorch CSR SpMV with its SpMM for blocks. PCG-AMG and BiCGSTAB
right-preconditioned by AMG on the symmetric part of the JAX test's
convection matrix stop within one step of the JAX solves, and PCG-AMG's
count does not grow with the grid (the JAX suite's headline check).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu.models import amg as jamg
from smvp_toolkit_tpu.models import solvers as jsol
from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr as jspmv_csr
from smvp_toolkit_tpu_torch.models import amg as tamg
from smvp_toolkit_tpu_torch.models import solvers as tsol
from smvp_toolkit_tpu_torch.ops import _build, spmv_sell, spmv_torch
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

from torch_systems import convection, pair, rel, same_bits, stop_step

TOL_APPLY = 1e-5
TOL_BLOCK = 1e-6


def _random_spd(n=400, seed=2):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.01, random_state=rng)
    a = a + a.T
    return a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 0.1)


def _symmetric_part(a):
    a = sp.csr_matrix(a)
    return sp.coo_matrix((a + a.T) * 0.5)


GRAPHS = {
    "poisson24": lambda: poisson2d(24),
    "hpcg8": lambda: hpcg_stencil(8),
    "random-spd": _random_spd,
    "convection-sym": lambda: _symmetric_part(convection()),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("theta", [0.08, 0.25])
def test_aggregates_equal_across_passes(name, theta, monkeypatch):
    a = sp.csr_matrix(GRAPHS[name]())
    s = tamg._strength_graph(a, theta)
    js = jamg._strength_graph(a, theta)
    assert np.array_equal(s.indptr, js.indptr)
    assert np.array_equal(s.indices, js.indices)
    native = tamg._aggregate_native(s)
    numpy_ = tamg._aggregate_numpy(s)
    j_native = jamg._aggregate(js)
    monkeypatch.setenv("SMVP_NATIVE_AMG", "0")
    j_numpy = jamg._aggregate(js)
    for agg, nc in (numpy_, j_native, j_numpy):
        assert nc == native[1] and same_bits(agg, native[0])
    if name == "hpcg8" and theta == 0.08:  # no strong connection at all
        assert s.nnz == 0 and native[1] == a.shape[0]


def _same_csr(t, j):
    assert t.shape == tuple(j.shape) and t.nnz == j.nnz
    assert np.array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
    assert np.array_equal(t.col_ind.numpy(), np.asarray(j.col_ind))
    assert same_bits(t.vals.numpy(), j.vals)


SETUPS = {
    "poisson24-c64": (lambda: poisson2d(24), dict(coarse_size=64)),
    "poisson32": (lambda: poisson2d(32), {}),
    "random-spd": (_random_spd, dict(coarse_size=32)),
    "convection-sym": (lambda: _symmetric_part(convection()),
                       dict(theta=0.2, coarse_size=40)),
}


@pytest.mark.parametrize("name", sorted(SETUPS))
@pytest.mark.parametrize("native", [True, False])
def test_hierarchy_equals_jax(name, native):
    build, kw = SETUPS[name]
    _, jcsr, _, tcsr = pair(build())
    jl = jamg.amg_setup(jcsr, **kw)
    tl = tamg.amg_setup(tcsr, native=native, **kw)
    assert [lv.n for lv in tl] == [lv.n for lv in jl]
    assert len(tl) >= 2
    assert tl[0].a_csr is tcsr  # level 0 reuses the caller's matrix
    for t, j in zip(tl, jl):
        if j.coarse_inv is not None:
            assert t.a_csr is None and t.p_csr is None
            assert same_bits(t.coarse_inv.numpy(), j.coarse_inv)
            continue
        assert t.omega == j.omega and t.rho == j.rho
        assert same_bits(t.inv_diag.numpy(), j.inv_diag)
        for tpart, jpart in ((t.p_csr, j.p_csr), (t.pt_csr, j.pt_csr)):
            _same_csr(tpart, jpart)
        if t.a_csr is not tcsr:
            _same_csr(t.a_csr, j.a_csr)


def test_stalled_coarsening_refused_as_jax():
    """HPCG's off-diagonal |-1| is below 0.08·√(26·26): no strong edge, so
    aggregation stalls at level 0, above the dense limit."""
    _, jcsr, _, tcsr = pair(hpcg_stencil(17))
    with pytest.raises(ValueError, match="coarsening stalled") as te:
        tamg.amg_setup(tcsr)
    with pytest.raises(ValueError, match="coarsening stalled") as je:
        jamg.amg_setup(jcsr)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="coarsening stalled"):
        tamg.amg_preconditioner(tcsr)


def test_factory_refusals_match_jax():
    _, _, _, tcsr = pair(poisson2d(8))
    with pytest.raises(ValueError, match="sweeps"):
        tamg.amg_preconditioner(tcsr, sweeps=0)
    with pytest.raises(ValueError, match="smoother"):
        tamg.amg_preconditioner(tcsr, smoother="gauss-seidel")
    levels = tamg.amg_setup(tcsr, coarse_size=16)
    with pytest.raises(ValueError, match="no effect"):
        tamg.amg_preconditioner(tcsr, levels=levels, theta=0.1)
    _, _, _, other = pair(poisson2d(9))
    with pytest.raises(ValueError, match="prebuilt hierarchy"):
        tamg.amg_preconditioner(other, levels=levels)


@pytest.fixture(scope="module")
def poisson24():
    jcoo, jcsr, tcoo, tcsr = pair(poisson2d(24))
    jl = jamg.amg_setup(jcsr, coarse_size=64)
    tl = tamg.amg_setup(tcsr, coarse_size=64)
    return dict(jcsr=jcsr, tcsr=tcsr, jl=jl, tl=tl)


OPERATORS = {
    "sell": dict(op_builder=spmv_sell.sell_op_csr),
    "default": {},
    "torch": dict(spmv=spmv_torch.spmv_csr),
}


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("sweeps,cycles", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("ops", sorted(OPERATORS))
def test_apply_matches_jax(poisson24, smoother, sweeps, cycles, ops):
    p = poisson24
    kw = dict(smoother=smoother, sweeps=sweeps, cycles=cycles)
    t_apply = tamg.amg_preconditioner(p["tcsr"], levels=p["tl"],
                                      **OPERATORS[ops], **kw)
    j_apply = jamg.amg_preconditioner(p["jcsr"], levels=p["jl"], **kw)
    r = np.random.default_rng(4).standard_normal(576).astype(np.float32)
    z = t_apply(torch.from_numpy(r))
    assert z.dtype == torch.float32 and z.shape == (576,)
    assert rel(z.numpy(), j_apply(jnp.asarray(r))) <= TOL_APPLY
    # a longer (padded) residual: M⁻¹ on its first n entries, zeros after
    longer = np.concatenate([r, np.ones(64, np.float32)])
    zp = t_apply(torch.from_numpy(longer))
    assert torch.equal(zp[:576], z) and not zp[576:].any()


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("ops", sorted(OPERATORS))
def test_block_apply_matches_columns(poisson24, smoother, ops):
    p = poisson24
    t_apply = tamg.amg_preconditioner(p["tcsr"], levels=p["tl"],
                                      smoother=smoother, sweeps=2,
                                      **OPERATORS[ops])
    assert t_apply.supports_block
    R = np.random.default_rng(5).standard_normal((576, 4)).astype(np.float32)
    Z = t_apply(torch.from_numpy(R))
    assert Z.shape == (576, 4)
    cols = torch.stack([t_apply(torch.from_numpy(R[:, j].copy()))
                        for j in range(4)], dim=1)
    assert rel(Z.numpy(), cols.numpy()) <= TOL_BLOCK
    j_apply = jamg.amg_preconditioner(p["jcsr"], levels=p["jl"],
                                      smoother=smoother, sweeps=2)
    assert rel(Z.numpy(), j_apply(jnp.asarray(R))) <= TOL_APPLY


def test_coarse_only_hierarchy_solves_in_one_pass():
    _, jcsr, _, tcsr = pair(poisson2d(6))
    t_apply = tamg.amg_preconditioner(tcsr, cycles=3)
    j_apply = jamg.amg_preconditioner(jcsr, cycles=3)
    r = np.random.default_rng(6).standard_normal(36).astype(np.float32)
    assert rel(t_apply(torch.from_numpy(r)).numpy(),
               j_apply(jnp.asarray(r))) <= TOL_BLOCK


def test_pcg_amg_counts_match_jax_and_do_not_grow():
    """The JAX suite's headline (tests/test_amg.py): PCG-AMG at 1e-6 on
    Poisson 16², 32², 48², each stop within one of the JAX solve's, the
    count at 48² no more than 16²'s plus 2."""
    counts = []
    for nx in (16, 32, 48):
        _, jcsr, _, tcsr = pair(poisson2d(nx))
        b = np.random.RandomState(0).randn(nx * nx).astype(np.float32)
        t_m = tamg.amg_preconditioner(tcsr, op_builder=spmv_sell.sell_op_csr)
        j_m = jamg.amg_preconditioner(jcsr)
        tx, tres = tsol.pcg_precond(tcsr, torch.from_numpy(b), t_m,
                                    num_iters=60, tol=1e-6)
        _, jres = jsol.pcg_precond(jcsr, jnp.asarray(b), j_m, num_iters=60,
                                   tol=1e-6)
        t_stop, j_stop = stop_step(tres.numpy(), b, 1e-6), stop_step(
            jres, b, 1e-6)
        assert t_stop < 60 and abs(t_stop - j_stop) <= 1
        a = poisson2d(nx)
        relres = np.linalg.norm(a @ tx.numpy().astype(np.float64) - b) / \
            np.linalg.norm(b)
        assert relres < 1e-5
        counts.append(t_stop)
    assert max(counts) <= 15 and counts[-1] <= counts[0] + 2


def test_bicgstab_amg_on_convection_matches_jax():
    """The -amg right preconditioning of the CLI: AMG on (A + Aᵀ)/2 of
    the upwind convection matrix; BiCGSTAB's stop within one of the JAX
    solve's and x within 1e-4 of max |x| after 5 steps."""
    a = convection()
    _, jcsr, _, tcsr = pair(a)
    _, jsym, _, tsym = pair(_symmetric_part(a))
    b = np.random.RandomState(3).randn(256).astype(np.float32)
    t_m = tamg.amg_preconditioner(tsym, op_builder=spmv_sell.sell_op_csr)
    j_m = jamg.amg_preconditioner(jsym)

    def t_spmv(m, v):
        return spmv_sell.spmv_csr_sell(m, t_m(v))

    def j_spmv(m, v):
        return jspmv_csr(m, j_m(v))

    tu, _ = tsol.bicgstab(tcsr, torch.from_numpy(b), num_iters=5, spmv=t_spmv)
    ju, _ = jsol.bicgstab(jcsr, jnp.asarray(b), num_iters=5, spmv=j_spmv)
    assert rel(t_m(tu).numpy(), j_m(ju)) <= 1e-4
    _, tres = tsol.bicgstab(tcsr, torch.from_numpy(b), num_iters=40,
                            spmv=t_spmv, tol=1e-6)
    _, jres = jsol.bicgstab(jcsr, jnp.asarray(b), num_iters=40, spmv=j_spmv,
                            tol=1e-6)
    t_stop, j_stop = stop_step(tres.numpy(), b, 1e-6), stop_step(jres, b,
                                                                 1e-6)
    assert j_stop <= 15 and abs(t_stop - j_stop) <= 1


def test_aggregation_without_its_cpp_pass_raises(monkeypatch):
    """A C++ pass that cannot be built raises; the set-up does not run the
    numpy loop in its place (the JAX package falls back quietly)."""
    _, _, _, tcsr = pair(poisson2d(12))

    def refuse(name, signatures):
        raise _build.KernelBuildError(f"no compiler for {name}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tamg, "_aggregate_numpy", None)  # fails if called
    with pytest.raises(_build.KernelBuildError, match="amg"):
        tamg.amg_setup(tcsr, coarse_size=16)
