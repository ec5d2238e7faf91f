"""The port's scan-loop SPD solvers (``models/solvers.py``) against the JAX
package's ``models/solvers.py``.

Same matrix, same b (seeded numpy), same iteration counts: JAX steps with
its XLA ``spmv_csr``, the port with its default SpMV (the SELL operator,
whose plain version runs on the CPU). x and the residual histories agree
within 1e-4 relative (float32 recurrences whose SpMVs and dot products sum
in other orders). With a tolerance the history keeps its length and
repeats the final norm past the stop, and on Poisson 96² the achieved CG
and IC(0)-PCG counts at 1e-6 are within one step of the JAX package's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu import models as jm
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.ops import ilu as jilu
from smvp_toolkit_tpu.ops.algebra import diagonal as jdiagonal
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.models import solvers as tm
from smvp_toolkit_tpu_torch.ops import ilu as tilu
from smvp_toolkit_tpu_torch.ops.algebra import diagonal
from smvp_toolkit_tpu_torch.utils.synth import poisson2d

TOL = 1e-4


def _random_spd(n=300, seed=2):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.02, random_state=rng)
    a = a + a.T
    return a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 1.0)


def _pair(a):
    """(JAX COO, JAX CSR, port COO, port CSR) of one matrix."""
    a = sp.coo_matrix(a)
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jcoo = JCOO.from_numpy(r, c, v, shape=a.shape, pad_to=128)
    tcoo = coo_from_triplets(r, c, v, a.shape, device="cpu").pad(128)
    return jcoo, jcsr_encode(jcoo), tcoo, csr_encode(tcoo)


@pytest.fixture(scope="module", params=["poisson16", "random-spd"])
def system(request):
    a = poisson2d(16) if request.param == "poisson16" else _random_spd()
    jcoo, jcsr, tcoo, tcsr = _pair(a)
    b = np.random.RandomState(0).randn(a.shape[0]).astype(np.float32)
    lam = np.linalg.eigvalsh(a.toarray())
    return dict(jcoo=jcoo, jcsr=jcsr, tcoo=tcoo, tcsr=tcsr, b=b,
                lam=(float(lam[0]), float(lam[-1])))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(t_out, j_out):
    (tx, tres), (jx, jres) = t_out, j_out
    assert _rel(tx.numpy(), jx) <= TOL
    assert tres.shape == tuple(np.shape(jres))
    assert _rel(tres.numpy(), jres) <= TOL


def test_diagonal_matches_jax(system):
    assert np.array_equal(diagonal(system["tcoo"]).numpy(),
                          np.asarray(jdiagonal(system["jcoo"])))


@pytest.mark.parametrize("iters", [1, 25])
def test_conjugate_gradient_matches_jax(system, iters):
    b = system["b"]
    _close(tm.conjugate_gradient(system["tcsr"], torch.from_numpy(b),
                                 num_iters=iters),
           jm.conjugate_gradient(system["jcsr"], jnp.asarray(b),
                                 num_iters=iters))


def test_pcg_matches_jax(system):
    b = system["b"]
    _close(tm.pcg(system["tcsr"], torch.from_numpy(b),
                  diagonal(system["tcoo"]), num_iters=25),
           jm.pcg(system["jcsr"], jnp.asarray(b), jdiagonal(system["jcoo"]),
                  num_iters=25))


@pytest.mark.parametrize("sweeps", [2, 4])
def test_pcg_ic0_matches_jax(system, sweeps):
    b = system["b"]
    tpre = tm.ic0_preconditioner(tilu.ic0(system["tcsr"]), sweeps=sweeps)
    jpre = jm.ic0_preconditioner(jilu.ic0(system["jcsr"]), sweeps=sweeps)
    _close(tm.pcg_precond(system["tcsr"], torch.from_numpy(b), tpre,
                          num_iters=20),
           jm.pcg_precond(system["jcsr"], jnp.asarray(b), jpre,
                          num_iters=20))


def test_chebyshev_matches_jax(system):
    b = system["b"]
    lo, hi = system["lam"]
    _close(tm.chebyshev(system["tcsr"], torch.from_numpy(b), lo, hi,
                        num_iters=40),
           jm.chebyshev(system["jcsr"], jnp.asarray(b), lo, hi,
                        num_iters=40))


def test_lanczos_eigsh_matches_jax(system):
    v0 = np.random.default_rng(0).standard_normal(
        system["b"].shape[0]).astype(np.float32)
    t_lo, t_hi = tm.lanczos_eigsh(system["tcsr"], torch.from_numpy(v0),
                                  num_iters=30, k=2)
    j_lo, j_hi = jm.lanczos_eigsh(system["jcsr"], jnp.asarray(v0),
                                  num_iters=30, k=2)
    assert _rel(t_lo, j_lo) <= TOL and _rel(t_hi, j_hi) <= TOL
    ta, tb, tv = tm.lanczos(system["tcsr"], torch.from_numpy(v0), 10)
    ja, jb, jv = jm.lanczos(system["jcsr"], jnp.asarray(v0), num_iters=10)
    assert _rel(ta.numpy(), ja) <= TOL and _rel(tb.numpy(), jb) <= TOL
    assert tv.shape == jv.shape and _rel(tv.numpy(), jv) <= TOL


@pytest.mark.parametrize("solver", ["cg", "pcg", "pcg-ic0"])
def test_tolerance_history_contract(system, solver):
    b = torch.from_numpy(system["b"])
    csr = system["tcsr"]
    kw = dict(num_iters=200, tol=1e-3)
    if solver == "cg":
        x, res = tm.conjugate_gradient(csr, b, **kw)
    elif solver == "pcg":
        x, res = tm.pcg(csr, b, diagonal(system["tcoo"]), **kw)
    else:
        pre = tm.ic0_preconditioner(tilu.ic0(csr))
        x, res = tm.pcg_precond(csr, b, pre, **kw)
    res = res.numpy()
    target = 1e-3 * np.linalg.norm(system["b"])
    stop = int(np.argmax(res <= target * (1 + 1e-6)))
    assert res.shape == (200,) and res[stop] <= target * (1 + 1e-6)
    assert 0 < stop < 199 and (res[:stop] > target).all()
    assert (res[stop:] == res[stop]).all()  # the final norm, repeated
    full, _ = tm.conjugate_gradient(csr, b, num_iters=stop + 1) if (
        solver == "cg") else (None, None)
    if full is not None:  # stopping changes nothing before the stop
        assert torch.equal(full, x)


def _count(res, b):
    ok = np.asarray(res) / np.linalg.norm(b) < 1e-6
    return int(np.argmax(ok)) + 1 if ok.any() else None


def test_poisson96_iteration_counts_match_jax():
    jcoo, jcsr, tcoo, tcsr = _pair(poisson2d(96))
    b = np.random.RandomState(0).randn(96 * 96).astype(np.float32)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    _, t_cg = tm.conjugate_gradient(tcsr, bt, num_iters=600, tol=1e-6)
    _, j_cg = jm.conjugate_gradient(jcsr, bj, num_iters=600, tol=1e-6)
    t_pre = tm.ic0_preconditioner(tilu.ic0(tcsr), sweeps=4)
    j_pre = jm.ic0_preconditioner(jilu.ic0(jcsr), sweeps=4)
    _, t_ic = tm.pcg_precond(tcsr, bt, t_pre, num_iters=600, tol=1e-6)
    _, j_ic = jm.pcg_precond(jcsr, bj, j_pre, num_iters=600, tol=1e-6)
    counts = [(_count(t.numpy(), b), _count(j, b))
              for t, j in ((t_cg, j_cg), (t_ic, j_ic))]
    for got, want in counts:
        assert got is not None and want is not None
        assert abs(got - want) <= 1, counts
    # IC(0) needs about a third of CG's steps (PERFORMANCE.md: 246 and 83)
    assert counts[1][0] * 2 < counts[0][0]
