"""The rest of the plain path (``ops/spmv_torch.py``) against the JAX
package's XLA kernels (``ops/spmv_xla.py``): ``spmv_coo``,
``spmv_csr_cumsum`` and ``spmm_tjds``, and the three the port had
(``spmv_csr``, ``spmv_tjds``, ``spmm_csr``) in complex64, on the same
numpy-seeded triplets and x, in float32 and complex64.

Tolerances. The gather-and-sum kernels: 1e-6 of max |y| (both sum each
row's products in float32, in orders that may differ). ``spmv_csr_cumsum``
takes each row as the difference of two entries of one float32 prefix sum
over all products, so each row carries the prefix's rounding: both
packages are held to the float64 oracle within 4·eps32·max |P| per row
(P the prefix, counted from |products| and in float64), and to each other
within twice that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr
from smvp_toolkit_tpu.formats.tjds import tjds_encode as jtjds
from smvp_toolkit_tpu.ops import spmv_xla as jx
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
from smvp_toolkit_tpu_torch.ops import spmv_torch as tx

TOL = 1e-6
EPS32 = float(np.finfo(np.float32).eps)
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "complex64": (np.complex64, jnp.complex64, torch.complex64)}


def _case(dtype, n=700, nnz=5000, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    key = np.unique(r * n + c)
    r, c = (key // n).astype(np.int32), (key % n).astype(np.int32)
    v = rng.standard_normal(len(r))
    x = rng.standard_normal(n)
    if dtype == "complex64":
        v = v + 1j * rng.standard_normal(len(r))
        x = x + 1j * rng.standard_normal(n)
    npd, jd, td = DTYPES[dtype]
    v, x = v.astype(npd), x.astype(npd)
    jc = JCOO.from_numpy(r, c, v, shape=(n, n), dtype=jd, pad_to=128)
    tc = COOMatrix.from_numpy(r, c, v, shape=(n, n), dtype=td, pad_to=128,
                              device="cpu")
    ref = np.zeros(n, np.complex128)
    np.add.at(ref, r, v.astype(np.complex128) * x.astype(np.complex128)[c])
    return jc, tc, x, ref, (r, c, v)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", ["coo", "csr", "tjds"])
def test_spmv_matches_jax(dtype, kernel):
    jc, tc, x, ref, _ = _case(dtype)
    jm, tm = {"coo": (jc, tc), "csr": (jcsr(jc), csr_encode(tc)),
              "tjds": (jtjds(jc), tjds_encode(tc))}[kernel]
    yj = getattr(jx, f"spmv_{kernel}")(jm, jnp.asarray(x))
    yt = getattr(tx, f"spmv_{kernel}")(tm, torch.from_numpy(x))
    assert yt.dtype == DTYPES[dtype][2] and yt.shape == (700,)
    assert _close(yt.numpy(), yj)
    assert _close(yt.numpy(), ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_csr_cumsum_matches_jax(dtype):
    jc, tc, x, ref, (r, c, v) = _case(dtype, nnz=20000, seed=2)
    jm, tm = jcsr(jc), csr_encode(tc)
    yj = np.asarray(jx.spmv_csr_cumsum(jm, jnp.asarray(x)))
    yt = tx.spmv_csr_cumsum(tm, torch.from_numpy(x)).numpy()
    assert yt.dtype == DTYPES[dtype][0]
    prods = np.abs(v.astype(np.complex128) * x.astype(np.complex128)[c])
    bound = 4 * EPS32 * prods.sum()  # >= max |P| along the prefix
    assert np.abs(yt - ref).max() <= bound
    assert np.abs(np.asarray(yj) - ref).max() <= bound
    assert np.abs(yt - yj).max() <= 2 * bound
    # an empty row is an exact 0 (two equal prefix entries)
    rows = np.bincount(r, minlength=700)
    assert np.all(yt[rows == 0] == 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", ["csr", "tjds"])
def test_spmm_matches_jax(dtype, kernel):
    jc, tc, _, _, _ = _case(dtype, seed=5)
    rng = np.random.default_rng(6)
    X = rng.standard_normal((700, 5)).astype(DTYPES[dtype][0])
    if dtype == "complex64":
        X = (X + 1j * rng.standard_normal((700, 5))).astype(np.complex64)
    jm, tm = ((jcsr(jc), csr_encode(tc)) if kernel == "csr"
              else (jtjds(jc), tjds_encode(tc)))
    Yj = np.asarray(getattr(jx, f"spmm_{kernel}")(jm, jnp.asarray(X)))
    Yt = getattr(tx, f"spmm_{kernel}")(tm, torch.from_numpy(X)).numpy()
    assert Yt.shape == (700, 5) and _close(Yt, Yj)
