"""The port's IC(0) (``ops/ilu.py``, ``csrc/ilu.cpp``) against the JAX
package's ``ops/ilu.py``.

The port's numpy pass and its C++ copy (built here with the host compiler)
are held bit for bit to the JAX numpy pass on the same CSR arrays: the
factor values, the lower cut per row, diag(L) and the breakdown count.
``ic0`` must give the same factor CSR arrays and the same shift-ladder
warning; ``trisolve_neumann`` agrees within 1e-6 relative (float32 SpMVs
in another summation order).
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
from smvp_toolkit_tpu_torch.ops import ilu as tilu
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

TOL_APPLY = 1e-6


def _random_spd(n=300, seed=3):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.02, random_state=rng)
    a = a + a.T
    return a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 1.0)


def _indefinite(n=60, seed=4):
    """A pattern matrix (all ones, unit diagonal): indefinite, so IC(0)
    breaks down in a cascade and walks the shift ladder."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, n))
    for _ in range(6 * n):
        i, j = rng.randint(0, n, 2)
        a[i, j] = a[j, i] = 1.0
    np.fill_diagonal(a, 1.0)
    return sp.coo_matrix(a)


MATRICES = {
    "poisson14": lambda: poisson2d(14),
    "poisson32": lambda: poisson2d(32),
    "hpcg8": lambda: hpcg_stencil(8),
    "hpcg12": lambda: hpcg_stencil(12),
    "random-spd": _random_spd,
    "indefinite": _indefinite,
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def pair(request):
    """(name, JAX CSR, port CSR) of the same matrix."""
    a = sp.coo_matrix(MATRICES[request.param]())
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jc = jcsr_encode(JCOO.from_numpy(r, c, v, shape=a.shape, pad_to=128))
    tc = csr_encode(coo_from_triplets(r, c, v, a.shape, device="cpu").pad(128))
    return request.param, jc, tc


def test_csr_host_arrays_equal(pair):
    _, jc, tc = pair
    for got, want in zip(tilu._csr_host(tc), jilu._csr_host(jc)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_passes_bit_identical_to_jax(pair, shift):
    _, jc, _ = pair
    rp, ci, v = jilu._csr_host(jc)
    n = len(rp) - 1
    want = jilu._ic0_pass(rp, ci, v, n, shift, 1e-3)
    for pass_fn in (tilu._ic0_pass, tilu._native_ic0_pass):
        got = pass_fn(rp, ci, v, n, shift, 1e-3)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert got[3] == want[3]


def _caught(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


@pytest.mark.parametrize("native", [True, False])
def test_ic0_factors_equal_jax(pair, native):
    name, jc, tc = pair
    jf, jwarn = _caught(lambda: jilu.ic0(jc))
    tf, twarn = _caught(lambda: tilu.ic0(tc, native=native))
    assert twarn == jwarn
    if name == "indefinite":  # the shift ladder ran and said so
        assert len(twarn) == 1 and "diagonal shift" in twarn[0]
    for tpart, jpart in ((tf.strict, jf.strict), (tf.strict_t, jf.strict_t)):
        assert tpart.shape == jpart.shape and tpart.nnz == jpart.nnz
        assert np.array_equal(tpart.row_ptr.numpy(), np.asarray(jpart.row_ptr))
        assert np.array_equal(tpart.col_ind.numpy(), np.asarray(jpart.col_ind))
        assert tpart.vals.numpy().tobytes() == np.asarray(
            jpart.vals).tobytes()
    assert tf.diag.numpy().tobytes() == np.asarray(jf.diag).tobytes()


@pytest.mark.parametrize("sweeps", [1, 3, 4])
def test_trisolve_neumann_matches_jax(pair, sweeps):
    _, jc, tc = pair
    jf, tf = jilu.ic0(jc), tilu.ic0(tc)
    r = np.random.default_rng(sweeps).standard_normal(tc.shape[0]).astype(
        np.float32)
    for tpart, jpart in ((tf.strict, jf.strict), (tf.strict_t, jf.strict_t)):
        want = np.asarray(jilu.trisolve_neumann(jpart, jf.diag,
                                                jnp.asarray(r), sweeps))
        got = tilu.trisolve_neumann(tpart, tf.diag, torch.from_numpy(r),
                                    sweeps).numpy()
        assert np.abs(got - want).max() <= TOL_APPLY * np.abs(want).max()


def test_ic0_refuses_rectangular_and_complex():
    tc = csr_encode(coo_from_triplets(np.array([0]), np.array([1]),
                                      np.array([1.0]), (2, 3), device="cpu"))
    with pytest.raises(ValueError, match="square"):
        tilu.ic0(tc)
    tz = csr_encode(coo_from_triplets(
        np.array([0, 1]), np.array([0, 1]), np.array([1 + 1j, 2.0]), (2, 2),
        dtype=torch.complex64, device="cpu"))
    with pytest.raises(ValueError, match="real"):
        tilu.ic0(tz)
