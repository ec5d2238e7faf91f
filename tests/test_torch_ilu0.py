"""The port's ILU(0) and triangular split (``ops/ilu.py``, the
``ilu0_pass`` of ``csrc/ilu.cpp``) against the JAX package's
``ops/ilu.py``.

The port's numpy pass and its C++ copy (built here with the host compiler)
are held bit for bit to the JAX numpy pass on the same CSR arrays, at
every step of the shift ladder: the factor value at every slot,
``u_diag`` and the floored-pivot count. ``ilu0`` gives the same factor
CSR arrays and ``u_diag``, bit for bit, with the same warning where the
ladder or the pivot floor ran; ``split_triangular`` the same three parts.
The unit-lower and upper Neumann applies agree within 1e-6 relative
(float32 SpMVs in another summation order). A C++ pass that cannot be
built raises: nothing falls back to the numpy loop quietly.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.ops import ilu as jilu
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops import ilu as tilu
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

TOL_APPLY = 1e-6


def _convection(nx=16, seed=9):
    """The JAX AMG test's upwind convection-diffusion matrix
    (tests/test_amg.py): Poisson nx² with 70% of the superdiagonal
    entries lowered by 0.35."""
    a = poisson2d(nx).toarray()
    rng = np.random.RandomState(seed)
    for kk in range(a.shape[0] - 1):
        if rng.rand() < 0.7 and a[kk, kk + 1] != 0:
            a[kk, kk + 1] -= 0.35
    return sp.coo_matrix(a)


def _random_general(n=250, seed=5):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.03, random_state=rng)
    return a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 0.5)


def _missing_diagonal(n=80, seed=6):
    """Random entries, every fifth diagonal entry structurally absent:
    pivots fall to the static floor."""
    a = sp.lil_matrix(_random_general(n, seed))
    for i in range(0, n, 5):
        a[i, i] = 0.0
    return sp.coo_matrix(a.tocsr()).tocsr().tocoo()


def _singular(n=60, seed=4):
    """A pattern matrix (ones, unit diagonal): the pivot repair cascades
    and the factorization walks the shift ladder."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, n))
    for _ in range(6 * n):
        i, j = rng.randint(0, n, 2)
        a[i, j] = 1.0
    np.fill_diagonal(a, 1.0)
    return sp.coo_matrix(a)


MATRICES = {
    "poisson14": lambda: poisson2d(14),
    "hpcg8": lambda: hpcg_stencil(8),
    "convection16": _convection,
    "random-general": _random_general,
    "missing-diagonal": _missing_diagonal,
    "singular": _singular,
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def pair(request):
    """(name, JAX CSR, port CSR) of the same matrix."""
    a = sp.coo_matrix(MATRICES[request.param]())
    a.eliminate_zeros()
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jc = jcsr_encode(JCOO.from_numpy(r, c, v, shape=a.shape, pad_to=128))
    tc = csr_encode(coo_from_triplets(r, c, v, a.shape, device="cpu").pad(128))
    return request.param, jc, tc


def _bits(a):
    return np.asarray(a).dtype, np.asarray(a).tobytes()


def test_ilu0_passes_bit_identical_to_jax_across_the_ladder(pair):
    _, jc, _ = pair
    rp, ci, v = jilu._csr_host(jc)
    n = len(rp) - 1
    scale = float(np.abs(v).max())
    floor = scale * 1e-4
    with np.errstate(over="ignore", invalid="ignore"):
        for shift in tilu._shift_ladder(scale):
            want = jilu._ilu0_pass(rp, ci, v, n, shift, floor)
            for pass_fn in (tilu._ilu0_pass, tilu._native_ilu0_pass):
                got = pass_fn(rp, ci, v, n, shift, floor)
                for g, w in zip(got[:2], want[:2]):
                    assert _bits(g) == _bits(w)
                assert got[2] == want[2]


def _caught(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


def _same_csr(t, j):
    assert t.shape == tuple(j.shape) and t.nnz == j.nnz
    assert np.array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
    assert np.array_equal(t.col_ind.numpy(), np.asarray(j.col_ind))
    assert _bits(t.vals.numpy()) == _bits(j.vals)


@pytest.mark.parametrize("native", [True, False])
def test_ilu0_factors_equal_jax(pair, native):
    name, jc, tc = pair
    jf, jwarn = _caught(lambda: jilu.ilu0(jc))
    tf, twarn = _caught(lambda: tilu.ilu0(tc, native=native))
    assert twarn == jwarn
    if name in ("singular", "missing-diagonal"):
        assert len(twarn) == 1 and "ilu0:" in twarn[0]
    _same_csr(tf.l_strict, jf.l_strict)
    _same_csr(tf.u_strict, jf.u_strict)
    assert _bits(tf.u_diag.numpy()) == _bits(jf.u_diag)
    assert tf.shape == tuple(jf.shape)


def test_split_triangular_equals_jax(pair):
    _, jc, tc = pair
    jl, jd, ju = jilu.split_triangular(jc)
    tl, td, tu = tilu.split_triangular(tc)
    _same_csr(tl, jl)
    _same_csr(tu, ju)
    assert _bits(td.numpy()) == _bits(jd)


@pytest.mark.parametrize("sweeps", [1, 4])
def test_ilu0_neumann_applies_match_jax(pair, sweeps):
    _, jc, tc = pair
    jf, tf = jilu.ilu0(jc), tilu.ilu0(tc)
    r = np.random.default_rng(sweeps).standard_normal(tc.shape[0]).astype(
        np.float32)
    for tpart, tdiag, jpart, jdiag in (
            (tf.l_strict, None, jf.l_strict, None),
            (tf.u_strict, tf.u_diag, jf.u_strict, jf.u_diag)):
        want = np.asarray(jilu.trisolve_neumann(jpart, jdiag, jnp.asarray(r),
                                                sweeps))
        got = tilu.trisolve_neumann(tpart, tdiag, torch.from_numpy(r),
                                    sweeps).numpy()
        assert np.abs(got - want).max() <= TOL_APPLY * np.abs(want).max()


def test_ilu0_and_split_refuse_rectangular_and_complex():
    tc = csr_encode(coo_from_triplets(np.array([0]), np.array([1]),
                                      np.array([1.0]), (2, 3), device="cpu"))
    for fn in (tilu.ilu0, tilu.split_triangular):
        with pytest.raises(ValueError, match="square"):
            fn(tc)
    tz = csr_encode(coo_from_triplets(
        np.array([0, 1]), np.array([0, 1]), np.array([1 + 1j, 2.0]), (2, 2),
        dtype=torch.complex64, device="cpu"))
    with pytest.raises(ValueError, match="real"):
        tilu.ilu0(tz)


def test_ilu0_without_its_cpp_pass_raises(monkeypatch):
    """A C++ pass that cannot be built raises; ilu0 does not run the numpy
    loop in its place."""
    a = poisson2d(4).tocoo()
    tc = csr_encode(coo_from_triplets(a.row, a.col, a.data, a.shape,
                                      device="cpu"))

    def refuse(name, signatures):
        raise _build.KernelBuildError(f"no compiler for {name}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tilu, "_ilu0_pass", None)  # would fail if called
    with pytest.raises(_build.KernelBuildError, match="ilu"):
        tilu.ilu0(tc)
