"""The port's MatrixMarket reader and writer against ``scipy.io``.

The JAX suite's differential (``tests/test_mtx_scipy_diff.py``) on the
port: scipy's ``mmread``/``mmwrite`` is an independent implementation of
the format. Its nine field and symmetry cases, two seeds each, in both
directions:

* files scipy writes must read here as scipy reads them, through the
  Python parser (``read_mtx(use_native=False)``) and through the native
  one (``csrc/mtxio.cpp``, ``use_native=True``), which hands complex files
  to the Python parser (``io/native.py`` raises ``NativeUnavailable`` for
  them; the test checks that it does, and that it reads every other case
  itself);
* files the port's ``write_mtx`` writes (the stored triangle of a
  symmetric, skew or Hermitian matrix) must read in scipy as the matrix
  they hold.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import scipy.io as scipy_io
import scipy.sparse

from smvp_toolkit_tpu_torch.io import native
from smvp_toolkit_tpu_torch.io.mtx import read_mtx, write_mtx

from test_mtx_scipy_diff import CASES, _random_sparse, _scipy_bytes


@pytest.mark.parametrize("field,symmetry", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_reader_matches_scipy(field, symmetry, seed, tmp_path):
    rng = np.random.RandomState(seed)
    a = _random_sparse(rng, field=field, symmetry=symmetry)
    if field == "pattern" and symmetry == "symmetric":
        a = (np.abs(a) > 0).astype(np.float64)  # pattern stores structure
    path = tmp_path / "m.mtx"
    path.write_bytes(_scipy_bytes(a, field, symmetry))

    a_scipy = scipy_io.mmread(str(path))
    if scipy.sparse.issparse(a_scipy):
        a_scipy = a_scipy.toarray()

    if field == "complex":
        with pytest.raises(native.NativeUnavailable):
            native.read_mtx_raw_native(str(path))
    else:
        assert native.read_mtx_raw_native(str(path))[0].field == field
    dtype = np.complex128 if field == "complex" else np.float64
    for use_native in (False, True):
        coo = read_mtx(str(path), expand_symmetry=True,
                       use_native=use_native, device="cpu")
        np.testing.assert_allclose(
            coo.to_dense(dtype=dtype), a_scipy, rtol=1e-6, atol=1e-9,
            err_msg=f"{field}/{symmetry} native={use_native}",
        )


def _stored_triangle(a, symmetry):
    """The entries a one-triangle file stores: the lower triangle (strictly
    lower for skew-symmetric storage), or every entry of a general one."""
    if symmetry == "general":
        keep = np.ones(a.shape, bool)
    else:
        keep = np.tril(np.ones(a.shape, bool), -1 if symmetry ==
                       "skew-symmetric" else 0)
    r, c = np.nonzero((a != 0) & keep)
    return r, c, a[r, c]


@pytest.mark.parametrize("field,symmetry", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_writer_matches_scipy(field, symmetry, seed, tmp_path):
    """Files the port writes read in scipy as the matrix they hold."""
    rng = np.random.RandomState(seed)
    a = _random_sparse(rng, field=field, symmetry=symmetry)
    if field == "pattern":
        a = (np.abs(a) > 0).astype(np.float64)
    r, c, v = _stored_triangle(a, symmetry)
    if field == "integer":
        v = v.astype(np.int64)
    path = str(tmp_path / "w.mtx")
    write_mtx(path, r, c, None if field == "pattern" else v, a.shape,
              field=field, symmetry=symmetry)
    back = scipy_io.mmread(path)
    if scipy.sparse.issparse(back):
        back = back.toarray()
    np.testing.assert_allclose(back, a, rtol=1e-12, atol=0)


def test_writer_text_reads_back_in_the_port():
    """A written file reads back in the port with the same triplets."""
    rng = np.random.RandomState(5)
    a = _random_sparse(rng, field="real", symmetry="symmetric")
    r, c, v = _stored_triangle(a, "symmetric")
    buf = io.StringIO()
    write_mtx(buf, r, c, v, a.shape, symmetry="symmetric")
    coo = read_mtx(io.StringIO(buf.getvalue()), dtype=None, device="cpu")
    rb, cb, _ = coo.to_numpy()
    assert coo.typecode.symmetry == "symmetric"
    assert np.array_equal(rb, r) and np.array_equal(cb, c)
    np.testing.assert_allclose(coo.to_scipy().toarray(), a, rtol=1e-6)
