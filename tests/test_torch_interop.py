"""The port's COO bridges and CSR helpers against the JAX package's.

The cases of the JAX suite's ``tests/test_interop.py`` but its BCOO ones
(``from_bcoo``/``to_bcoo`` take and give JAX types, which the port does
not import; ``from_torch``/``to_torch`` bridge to ``torch.sparse`` in
their place), each run through both packages on the same input: the
triplets equal, ``to_scipy`` equal, ``to_torch`` equal element for element
(indices and values of the coalesced tensors), ``to_dense`` equal, the
symmetric expansion and the bfloat16 upcast as in JAX. Then
``CSRMatrix.footprint_bytes`` and ``with_row_ids`` against the JAX
methods. The port's matrices are built on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_encode
from smvp_toolkit_tpu.io.mtx import read_mtx as j_read_mtx
from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr as j_spmv_csr
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode, read_mtx
from smvp_toolkit_tpu_torch.ops.spmv_torch import spmv_csr

CPU = dict(device="cpu")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _random_scipy(m=37, n=23, density=0.15, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    mat = scipy_sparse.random(
        m, n, density=density, random_state=rng, dtype=np.float64
    )
    return mat.astype(dtype)


def _same_triplets(t: COOMatrix, j: JCOO):
    """Shape, counts, padding, typecode and the true triplets equal bit
    for bit (values as float32 where JAX holds bfloat16)."""
    assert t.shape == tuple(j.shape) and t.nnz == j.nnz
    assert t.nnz_padded == j.nnz_padded
    assert str(t.typecode) == str(j.typecode)
    for a, b in zip(t.to_numpy(), j.to_numpy()):
        b = np.asarray(b)
        if b.dtype.kind not in "fciu":  # ml_dtypes bfloat16
            b = b.astype(np.float32)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_scipy(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for f in ("row", "col", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _same_torch(t: torch.Tensor, j: torch.Tensor):
    """Two coalesced sparse tensors equal element for element."""
    assert t.layout == j.layout == torch.sparse_coo
    assert t.is_coalesced() and j.is_coalesced()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert torch.equal(t.indices(), j.indices())
    assert torch.equal(t.values(), j.values())


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_round_trip_dense_equal(fmt):
    sp = _random_scipy()
    sp_fmt = getattr(sp, "to" + fmt)()
    coo = COOMatrix.from_scipy(sp_fmt, **CPU)
    _same_triplets(coo, JCOO.from_scipy(sp_fmt))
    np.testing.assert_allclose(coo.to_dense(), sp.toarray(), rtol=1e-6,
                               atol=1e-6)
    back = coo.to_scipy()
    _same_scipy(back, JCOO.from_scipy(sp_fmt).to_scipy())
    np.testing.assert_allclose(back.toarray(), sp.toarray(), rtol=1e-6,
                               atol=1e-6)


def test_spmv_matches_scipy():
    sp = _random_scipy(m=64, n=64, density=0.1, seed=1)
    coo = COOMatrix.from_scipy(sp, pad_to=128, **CPU)
    jcoo = JCOO.from_scipy(sp, pad_to=128)
    _same_triplets(coo, jcoo)
    x = np.random.RandomState(2).randn(64)
    y = spmv_csr(csr_encode(coo), torch.from_numpy(x).float()).numpy()
    yj = np.asarray(j_spmv_csr(j_encode(jcoo), jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(y, sp @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, yj, rtol=1e-6, atol=1e-6)


def test_duplicates_are_preserved_and_summed():
    r = np.array([0, 0, 1])
    c = np.array([1, 1, 2])
    v = np.array([2.0, 3.0, 4.0])
    sp = scipy_sparse.coo_matrix((v, (r, c)), shape=(3, 4))
    coo = COOMatrix.from_scipy(sp, **CPU)
    _same_triplets(coo, JCOO.from_scipy(sp))
    assert coo.nnz == 3  # duplicates kept as entries
    assert coo.to_dense()[0, 1] == 5.0  # summed on materialization
    assert coo.to_scipy().toarray()[0, 1] == 5.0
    assert coo.to_torch().to_dense()[0, 1] == 5.0  # coalesced on export


def test_complex_promotes():
    sp = _random_scipy(dtype=np.complex128)
    sp = sp + 1j * _random_scipy(seed=3, dtype=np.float64)
    coo = COOMatrix.from_scipy(sp.tocoo(), **CPU)
    jcoo = JCOO.from_scipy(sp.tocoo())
    assert coo.dtype == torch.complex64 and jcoo.dtype == jnp.complex64
    _same_triplets(coo, jcoo)
    np.testing.assert_array_equal(coo.to_dense(dtype=np.complex128),
                                  jcoo.to_dense(dtype=np.complex128))
    np.testing.assert_allclose(coo.to_dense(dtype=np.complex128),
                               sp.toarray(), rtol=1e-5, atol=1e-5)
    _same_torch(coo.to_torch(), jcoo.to_torch())


def test_pad_to_respected():
    sp = _random_scipy()
    coo = COOMatrix.from_scipy(sp, pad_to=256, **CPU)
    _same_triplets(coo, JCOO.from_scipy(sp, pad_to=256))
    assert coo.nnz_padded % 256 == 0
    assert coo.nnz == sp.nnz
    rows = coo.rows[coo.nnz:]
    assert bool((rows == coo.nrows).all()) and not coo.vals[coo.nnz:].any()


@pytest.mark.parametrize("layout", ["coo", "csr", "csc", "dense"])
def test_torch_round_trip(layout):
    rng = np.random.RandomState(40)
    dense = rng.randn(21, 17) * (rng.rand(21, 17) < 0.2)
    t = torch.tensor(dense)
    if layout != "dense":
        t = getattr(t, f"to_sparse_{layout}")()
    coo = COOMatrix.from_torch(t, **CPU)
    jcoo = JCOO.from_torch(t)
    _same_triplets(coo, jcoo)
    np.testing.assert_allclose(coo.to_dense(), dense, rtol=1e-6, atol=1e-9)
    back = coo.to_torch()
    _same_torch(back, jcoo.to_torch())
    np.testing.assert_allclose(back.to_dense().numpy(), dense, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_torch_dtype_and_padding_match_jax(dtype):
    """float64 values round as the JAX bridge rounds them, padding by the
    JAX rule."""
    rng = np.random.RandomState(42)
    dense = rng.randn(30, 26) * (rng.rand(30, 26) < 0.3)
    t = torch.tensor(dense).to_sparse_coo()
    tdt, jdt = DTYPES[dtype]
    coo = COOMatrix.from_torch(t, dtype=tdt, pad_to=64, **CPU)
    assert coo.dtype == tdt
    _same_triplets(coo, JCOO.from_torch(t, dtype=jdt, pad_to=64))


def test_torch_spmv_matches():
    rng = np.random.RandomState(41)
    dense = rng.randn(33, 33) * (rng.rand(33, 33) < 0.15)
    t = torch.tensor(dense).to_sparse_coo()
    coo = COOMatrix.from_torch(t, pad_to=64, **CPU)
    jcoo = JCOO.from_torch(t, pad_to=64)
    _same_triplets(coo, jcoo)
    x = rng.randn(33).astype(np.float32)
    y = spmv_csr(csr_encode(coo), torch.from_numpy(x)).numpy()
    yj = np.asarray(j_spmv_csr(j_encode(jcoo), jnp.asarray(x)))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y, yj, rtol=1e-6, atol=1e-6)


def test_torch_duplicates_coalesced():
    idx = torch.tensor([[0, 0, 1], [1, 1, 2]])
    vals = torch.tensor([2.0, 3.0, 4.0])
    t = torch.sparse_coo_tensor(idx, vals, size=(3, 4))
    coo = COOMatrix.from_torch(t, **CPU)
    _same_triplets(coo, JCOO.from_torch(t))
    assert coo.nnz == 2  # torch coalesce sums duplicates on entry
    assert coo.to_dense()[0, 1] == 5.0


def test_torch_complex_promotes_and_refuses_real_dtype():
    rng = np.random.RandomState(43)
    dense = (rng.randn(9, 7) + 1j * rng.randn(9, 7)) * (rng.rand(9, 7) < .4)
    t = torch.tensor(dense).to_sparse_coo()
    coo = COOMatrix.from_torch(t, **CPU)
    assert coo.dtype == torch.complex64
    _same_triplets(coo, JCOO.from_torch(t))
    with pytest.raises(TypeError, match="complex"):
        COOMatrix.from_torch(t, dtype=torch.float32, **CPU)
    with pytest.raises(ValueError, match="2-D"):
        COOMatrix.from_torch(torch.zeros(2, 3, 4), **CPU)


_SYMMETRIC = (
    "%%MatrixMarket matrix coordinate real symmetric\n"
    "3 3 3\n1 1 2.0\n3 1 5.0\n2 2 3.0\n"
)


def test_to_scipy_expands_symmetric_storage():
    """Stored-triangle typecodes export the full matrix (scipy and
    torch.sparse have no symmetry metadata)."""
    coo = read_mtx(io.StringIO(_SYMMETRIC), **CPU)
    jcoo = j_read_mtx(io.StringIO(_SYMMETRIC))
    assert coo.typecode.symmetry == "symmetric" and coo.nnz == 3
    expected = np.array([[2, 0, 5], [0, 3, 0], [5, 0, 0.0]])
    _same_scipy(coo.to_scipy(), jcoo.to_scipy())
    np.testing.assert_allclose(coo.to_scipy().toarray(), expected)
    _same_torch(coo.to_torch(), jcoo.to_torch())
    np.testing.assert_allclose(coo.to_torch().to_dense().numpy(), expected)


@pytest.mark.parametrize("symmetry", ["skew-symmetric", "hermitian"])
def test_export_expands_skew_and_hermitian(symmetry):
    r = np.array([0, 1, 2, 2])
    c = np.array([0, 0, 1, 2])
    v = np.array([1.0, 2 + 1j, 3 - 2j, 4.0]) if symmetry == "hermitian" \
        else np.array([0.0, 2.0, 3.0, 0.0])
    tc = dict(field="complex" if symmetry == "hermitian" else "real",
              symmetry=symmetry)
    dt = (torch.complex64, jnp.complex64) if symmetry == "hermitian" else (
        torch.float32, jnp.float32)
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 3), dtype=dt[0],
                               typecode=MMTypeCode(**tc), **CPU)
    from smvp_toolkit_tpu.io.mtx import MMTypeCode as JTypeCode

    jcoo = JCOO.from_numpy(r, c, v, shape=(3, 3), dtype=dt[1],
                           typecode=JTypeCode(**tc))
    _same_scipy(coo.to_scipy(), jcoo.to_scipy())
    _same_torch(coo.to_torch(), jcoo.to_torch())
    a = coo.to_scipy().toarray()
    sign = -1 if symmetry == "skew-symmetric" else 1
    np.testing.assert_array_equal(a, sign * (a.T.conj() if symmetry ==
                                             "hermitian" else a.T))


def test_to_scipy_torch_bf16_upcasts():
    sp = _random_scipy()
    coo = COOMatrix.from_scipy(sp, dtype=torch.bfloat16, **CPU)
    jcoo = JCOO.from_scipy(sp, dtype=jnp.bfloat16)
    _same_triplets(coo, jcoo)
    out = coo.to_scipy()
    assert out.dtype == np.float32
    _same_scipy(out, jcoo.to_scipy())
    np.testing.assert_allclose(out.toarray(), sp.toarray(), rtol=1e-2,
                               atol=1e-2)
    t = coo.to_torch()
    assert t.dtype == torch.float32
    _same_torch(t, jcoo.to_torch())
    np.testing.assert_allclose(t.to_dense().numpy(), sp.toarray(),
                               rtol=1e-2, atol=1e-2)


def test_round_trip_through_torch_keeps_triplets():
    """``from_torch(to_torch())`` of a coalesced COO gives its triplets."""
    sp = _random_scipy(m=50, n=40, density=0.2, seed=44)
    coo = COOMatrix.from_scipy(sp, pad_to=128, **CPU).canonical_order()
    back = COOMatrix.from_torch(coo.to_torch(), pad_to=128, **CPU)
    for a, b in zip(coo.to_numpy(), back.to_numpy()):
        assert np.array_equal(a, b)
    assert back.nnz_padded == coo.nnz_padded


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad", [None, 128])
def test_csr_footprint_bytes_matches_jax(dtype, pad):
    sp = _random_scipy(m=70, n=50, density=0.2, seed=7)
    tdt, jdt = DTYPES[dtype]
    csr = csr_encode(COOMatrix.from_scipy(sp, dtype=tdt, pad_to=pad, **CPU))
    jcsr = j_encode(JCOO.from_scipy(sp, dtype=jdt, pad_to=pad))
    assert csr.footprint_bytes() == jcsr.footprint_bytes()
    vsz = 2 if dtype == "bfloat16" else 4
    assert csr.footprint_bytes() == 71 * 4 + sp.nnz * (4 + vsz)


@pytest.mark.parametrize("pad", [None, 128])
def test_csr_with_row_ids_matches_jax(pad):
    sp = _random_scipy(m=60, n=45, density=0.1, seed=8)
    csr = csr_encode(COOMatrix.from_scipy(sp, pad_to=pad, **CPU))
    jcsr = j_encode(JCOO.from_scipy(sp, pad_to=pad), with_row_ids=False)
    bare = dataclasses.replace(csr, row_ids=None)
    got = bare.with_row_ids()
    assert got is not bare and bare.row_ids is None
    want = np.asarray(jcsr.with_row_ids().row_ids)
    assert np.array_equal(got.row_ids.numpy(), want)
    assert np.array_equal(got.row_ids.numpy(), csr.row_ids.numpy())
    assert got.with_row_ids() is got  # materialized once
