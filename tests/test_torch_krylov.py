"""The port's Krylov family and fixed-point solvers (``models/solvers.py``)
against the JAX package's: BiCGSTAB, MINRES, restarted GMRES, CGLS,
Jacobi iteration, block CG, power iteration and PageRank.

Fixed counts, float32: the same numpy-seeded b through both, the JAX
functions on their XLA CSR SpMV, the port on its default SpMV (the SELL
operator's plain version on the CPU), on Poisson 16² and the JAX AMG
test's upwind convection matrix (nonsymmetric): x within 1e-4 of max |x|,
the JAX package's tolerance for its fused solvers against their scan
loops. BiCGSTAB on the convection matrix is compared after 4 steps: its
residual jumps 25-fold at its sixth step there, and both packages' last-bit
differences grow to percents through that jump.

Where ``tol`` stops a solve, the two stopping steps differ by at most 1
(GMRES: by at most one restart). That is held in float64, both packages
on their CSR SpMV (JAX under ``jax.enable_x64``, the port on
``spmv_torch.spmv_csr``), where the trajectories start equal to 1e-16:
in float32 BiCGSTAB's erratic residual lets last-bit differences move its
stop by two steps on Poisson 16² (29 against 27 at 1e-6). BiCGSTAB is
held where it stops within about 30 steps (plain on Poisson 16²,
right-preconditioned by ILU(0) on Poisson 24²): its trajectory amplifies
rounding about a thousandfold every five steps, so that later stops part
even inside the JAX package, float64 on two SpMVs of its own (the XLA
CSR and a dense product: 55 and 50 steps at 1e-6 on Poisson 24², where
the port stops at 49).

GMRES solves its small least-squares problem by ``torch.linalg.pinv`` (an
SVD with the cutoff of ``jnp.linalg.lstsq(rcond=None)``, eps·max(m+1, m)
of the largest singular value), where the JAX function calls
``jnp.linalg.lstsq``: a stated departure, since ``torch.linalg.lstsq`` on
the card has only the full-rank ``gels`` driver. It is held here at a
happy breakdown (a matrix of three distinct eigenvalues, whose Krylov
space is exhausted after three steps, so H loses rank).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu import models as jm
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.ops.algebra import diagonal as jdiagonal
from smvp_toolkit_tpu.ops.spmv_xla import spmm_csr as jspmm_csr
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.models import solvers as tm
from smvp_toolkit_tpu_torch.ops import spmv_torch
from smvp_toolkit_tpu_torch.ops.algebra import diagonal
from smvp_toolkit_tpu_torch.utils.synth import poisson2d

from torch_systems import TOL_X, convection, pair, rel, stop_step


@pytest.fixture(scope="module")
def poisson():
    jcoo, jcsr, tcoo, tcsr = pair(poisson2d(16))
    b = np.random.RandomState(0).randn(256).astype(np.float32)
    return dict(jcoo=jcoo, jcsr=jcsr, tcoo=tcoo, tcsr=tcsr, b=b)


@pytest.fixture(scope="module")
def conv():
    jcoo, jcsr, tcoo, tcsr = pair(convection())
    b = np.random.RandomState(1).randn(256).astype(np.float32)
    return dict(jcoo=jcoo, jcsr=jcsr, tcoo=tcoo, tcsr=tcsr, b=b)


def _close(t_out, j_out, tol=TOL_X):
    (tx, tres), (jx, jres) = t_out, j_out
    assert rel(tx.numpy(), jx) <= tol
    assert tuple(tres.shape) == tuple(np.shape(jres))
    assert rel(tres.numpy(), jres) <= tol


@pytest.mark.parametrize("which,iters", [("poisson", 10), ("conv", 4)])
def test_bicgstab_matches_jax(poisson, conv, which, iters):
    s = poisson if which == "poisson" else conv
    _close(tm.bicgstab(s["tcsr"], torch.from_numpy(s["b"]), num_iters=iters),
           jm.bicgstab(s["jcsr"], jnp.asarray(s["b"]), num_iters=iters))


def _indefinite():
    """Poisson 16² shifted into the middle of its spectrum: symmetric,
    indefinite (MINRES's case)."""
    return poisson2d(16) - 4.0 * sp.eye(256)


@pytest.mark.parametrize("which", ["poisson", "indefinite"])
def test_minres_matches_jax(poisson, which):
    if which == "poisson":
        s = poisson
    else:
        jcoo, jcsr, tcoo, tcsr = pair(_indefinite())
        s = dict(jcsr=jcsr, tcsr=tcsr, b=poisson["b"])
    _close(tm.minres(s["tcsr"], torch.from_numpy(s["b"]), num_iters=30),
           jm.minres(s["jcsr"], jnp.asarray(s["b"]), num_iters=30))


@pytest.mark.parametrize("restart,cycles", [(10, 3), (20, 2)])
@pytest.mark.parametrize("which", ["poisson", "conv"])
def test_gmres_matches_jax(poisson, conv, which, restart, cycles):
    s = poisson if which == "poisson" else conv
    _close(tm.gmres(s["tcsr"], torch.from_numpy(s["b"]), restart=restart,
                    num_restarts=cycles),
           jm.gmres(s["jcsr"], jnp.asarray(s["b"]), restart=restart,
                    num_restarts=cycles))


def test_gmres_happy_breakdown_pinv_matches_lstsq():
    """Three distinct eigenvalues: after three Arnoldi steps w vanishes,
    H has rank 3 of 10, and the SVD solve with JAX's cutoff gives JAX's
    x (and the exact solution)."""
    d = np.repeat([1.0, 2.0, 5.0], [30, 20, 14])
    a = sp.diags(d)
    jcoo, jcsr, tcoo, tcsr = pair(a)
    b = np.random.RandomState(3).randn(64).astype(np.float32)
    tx, tres = tm.gmres(tcsr, torch.from_numpy(b), restart=10,
                        num_restarts=1)
    jx, jres = jm.gmres(jcsr, jnp.asarray(b), restart=10, num_restarts=1)
    assert np.all(np.isfinite(tx.numpy()))
    assert rel(tx.numpy(), jx) <= TOL_X
    assert rel(tx.numpy(), b / d) <= TOL_X
    assert float(tres[-1]) <= 1e-4 * np.linalg.norm(b)
    # the cutoff: torch's default rtol for an (m+1, m) H is JAX's rcond
    h = torch.zeros(11, 10)
    h[:3, :3] = torch.eye(3)
    h[3, 3] = torch.finfo(torch.float32).eps * 11 * 0.5  # below the cutoff
    assert torch.linalg.matrix_rank(h) == 3
    assert int(jnp.linalg.matrix_rank(jnp.asarray(h.numpy()))) == 3


def test_cgls_matches_jax():
    """A rectangular least-squares problem (120 × 70, 5% dense), 10
    steps: this system amplifies rounding about a thousandfold every five
    steps (both packages' float64 trajectories part by 1e-11 after 15
    steps, 1e-8 after 20)."""
    a = sp.random(120, 70, density=0.05, random_state=np.random.RandomState(5),
                  format="coo") + sp.eye(120, 70)
    jcoo, jcsr, tcoo, tcsr = pair(a)
    _, jcsr_t, _, tcsr_t = pair(a.T)
    b = np.random.RandomState(2).randn(120).astype(np.float32)
    _close(tm.cgls(tcsr, tcsr_t, torch.from_numpy(b), num_iters=10),
           jm.cgls(jcsr, jcsr_t, jnp.asarray(b), num_iters=10))


@pytest.mark.parametrize("which", ["poisson", "conv"])
def test_jacobi_matches_jax(poisson, conv, which):
    s = poisson if which == "poisson" else conv
    tx = tm.jacobi(s["tcsr"], torch.from_numpy(s["b"]), diagonal(s["tcoo"]),
                   num_iters=30)
    jx = jm.jacobi(s["jcsr"], jnp.asarray(s["b"]), jdiagonal(s["jcoo"]),
                   num_iters=30)
    assert rel(tx.numpy(), jx) <= TOL_X


@pytest.mark.parametrize("precond", [False, True])
def test_block_cg_matches_jax(poisson, precond):
    s = poisson
    B = np.random.RandomState(4).randn(256, 3).astype(np.float32)
    tpre = jpre = None
    if precond:  # a vector-only factory: applied per column
        tpre = tm.jacobi_preconditioner(s["tcsr"], diagonal(s["tcoo"]),
                                        order=3)
        jpre = jm.jacobi_preconditioner(s["jcsr"], jdiagonal(s["jcoo"]),
                                        order=3)
    tX, tres = tm.block_cg(s["tcsr"], torch.from_numpy(B), num_iters=12,
                           m=tpre)
    jX, jres = jm.block_cg(s["jcsr"], jnp.asarray(B), num_iters=12,
                           spmm=jspmm_csr, m=jpre)
    _close((tX, tres), (jX, jres))
    assert tuple(tres.shape) == (12, 3)


@pytest.mark.parametrize("tol", [None, 1e-4])
def test_power_iteration_matches_jax(poisson, tol):
    s = poisson
    x0 = np.random.RandomState(6).randn(256).astype(np.float32)
    tlam, tx = tm.power_iteration(s["tcsr"], torch.from_numpy(x0),
                                  num_iters=60, tol=tol)
    jlam, jx = jm.power_iteration(s["jcsr"], jnp.asarray(x0), num_iters=60,
                                  tol=tol)
    assert abs(float(tlam) - float(jlam)) <= TOL_X * abs(float(jlam))
    assert rel(tx.numpy(), jx) <= TOL_X


def _link_matrix(n=300, seed=8):
    """A column-stochastic link matrix of a random directed graph (every
    node links somewhere)."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([np.arange(n), rng.randint(0, n, 4 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.randint(0, n, 4 * n)])
    a = sp.coo_matrix((np.ones(src.size), (dst, src)), shape=(n, n)).tocsc()
    a.sum_duplicates()
    return sp.coo_matrix(a @ sp.diags(1.0 / np.asarray(a.sum(axis=0)).ravel()))


@pytest.mark.parametrize("tol", [None, 1e-6])
def test_pagerank_matches_jax(tol):
    _, jcsr, _, tcsr = pair(_link_matrix())
    tr = tm.pagerank(tcsr, num_iters=40, tol=tol)
    jr = jm.pagerank(jcsr, num_iters=40, tol=tol)
    assert tr.dtype == torch.float32 and rel(tr.numpy(), jr) <= TOL_X
    assert abs(float(tr.sum()) - 1.0) <= 1e-5


def _pair64(a):
    """(JAX CSR, port CSR) in float64 of one matrix, its values rounded to
    float32 first (the port's COO takes host values through float32)."""
    a = sp.coo_matrix(a)
    r, c = a.row.astype(np.int32), a.col.astype(np.int32)
    v = a.data.astype(np.float32).astype(np.float64)
    jcsr = jcsr_encode(JCOO.from_numpy(r, c, v, shape=a.shape,
                                       dtype=jnp.float64, pad_to=128))
    tcsr = csr_encode(coo_from_triplets(r, c, v, a.shape,
                                        dtype=torch.float64,
                                        device="cpu").pad(128))
    return jcsr, tcsr


SYSTEMS64 = {"poisson16": lambda: poisson2d(16),
             "poisson24": lambda: poisson2d(24), "conv": convection}


@pytest.mark.parametrize("method,system", [
    ("bicgstab", "poisson16"), ("bicgstab-ilu", "poisson24"),
    ("minres", "poisson24"), ("gmres", "poisson24"), ("cg", "poisson24"),
    ("gmres", "conv")])
@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_stopping_step_matches_jax_in_float64(method, system, tol):
    from smvp_toolkit_tpu.ops import ilu as jilu
    from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr as jspmv_csr
    from smvp_toolkit_tpu_torch.ops import ilu as tilu

    a = SYSTEMS64[system]()
    n = a.shape[0]
    b = np.random.RandomState(1).randn(n).astype(np.float32).astype(
        np.float64)
    spmv = spmv_torch.spmv_csr
    with jax.enable_x64(True):
        jcsr, tcsr = _pair64(a)
        bj, bt = jnp.asarray(b), torch.from_numpy(b)
        if method == "gmres":
            tx, tres = tm.gmres(tcsr, bt, restart=20, num_restarts=60,
                                spmv=spmv, tol=tol)
            jx, jres = jm.gmres(jcsr, bj, restart=20, num_restarts=60,
                                tol=tol)
        elif method == "bicgstab-ilu":  # right-preconditioned, as the CLI
            t_m = tm.ilu_preconditioner(tilu.ilu0(tcsr), spmv=spmv)
            j_m = jm.ilu_preconditioner(jilu.ilu0(jcsr))
            tu, tres = tm.bicgstab(tcsr, bt, num_iters=100, tol=tol,
                                   spmv=lambda m, v: spmv(m, t_m(v)))
            ju, jres = jm.bicgstab(jcsr, bj, num_iters=100, tol=tol,
                                   spmv=lambda m, v: jspmv_csr(m, j_m(v)))
            tx, jx = t_m(tu), j_m(ju)
        else:
            fn = {"bicgstab": (tm.bicgstab, jm.bicgstab),
                  "minres": (tm.minres, jm.minres),
                  "cg": (tm.conjugate_gradient, jm.conjugate_gradient)}
            tfn, jfn = fn[method]
            tx, tres = tfn(tcsr, bt, num_iters=400, spmv=spmv, tol=tol)
            jx, jres = jfn(jcsr, bj, num_iters=400, tol=tol)
        jres = np.asarray(jres)
        assert tres.dtype == torch.float64 and jres.dtype == np.float64
    t_stop, j_stop = stop_step(tres.numpy(), b, tol), stop_step(jres, b, tol)
    assert j_stop < len(jres) and abs(t_stop - j_stop) <= 1
    assert rel(tx.numpy(), jx) <= 1e-8
