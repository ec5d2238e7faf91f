"""COO/CSR formats and the synthetic generator: the port against JAX.

Host artifacts must match bit for bit: CSR ``row_ptr``/``col_ind``/
``vals``/``row_ids`` (empty rows, rectangular shapes, duplicates and nnz
padding included), the decode round trip, COO padding and canonical
order, and the synthetic matrices of the shared ``RandomState`` stream.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_decode as j_decode
from smvp_toolkit_tpu.formats.csr import csr_encode as j_encode
from smvp_toolkit_tpu.utils import synth as jsynth
from smvp_toolkit_tpu_torch.formats.csr import csr_decode, csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.utils import synth as tsynth

from conftest import random_coo

CASES = {
    # name: (nrows, ncols, nnz, duplicates, empty_rows)
    "square": (500, 500, 4000, False, True),
    "tall": (900, 130, 3000, False, True),
    "wide": (60, 2000, 1500, False, True),
    "dups": (300, 300, 5000, True, True),
    "dense-rows": (64, 64, 64 * 64, False, False),
    "one-entry": (7, 9, 1, False, True),
}


def _pair(name, seed=0, pad=None, dtype="float32"):
    nrows, ncols, nnz, dups, empty = CASES[name]
    rng = np.random.RandomState(seed + len(name))
    r, c, v = random_coo(rng, nrows, ncols, nnz, allow_duplicates=dups,
                         empty_rows=empty)
    j = JCOO.from_numpy(r, c, v, shape=(nrows, ncols),
                        dtype=getattr(jnp, dtype))
    t = coo_from_triplets(r, c, v, (nrows, ncols),
                          dtype=getattr(torch, dtype), device="cpu")
    if pad:
        j, t = j.pad(pad), t.pad(pad)
    return j, t


def _np(a):
    """Torch or JAX array → numpy, bfloat16 widened to float32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [None, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_csr_encode_bit_identical(name, pad, dtype):
    j, t = _pair(name, pad=pad, dtype=dtype)
    jc, tc = j_encode(j), csr_encode(t)
    assert (tc.nnz, tc.shape) == (jc.nnz, jc.shape)
    _same(tc.row_ptr, jc.row_ptr)
    _same(tc.col_ind, jc.col_ind)
    _same(tc.vals, jc.vals)
    _same(tc.row_ids, jc.row_ids)


@pytest.mark.parametrize("pad", [None, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_csr_decode_round_trip_bit_exact(name, pad):
    j, t = _pair(name, seed=1, pad=pad)
    tc = csr_encode(t)
    td = csr_decode(tc)
    jd = j_decode(j_encode(j))
    for a, b in zip(td.to_numpy(), jd.to_numpy()):
        _same(torch.from_numpy(a), b)
    # decode(encode(A)) is A in canonical (row, col) order
    for a, b in zip(td.to_numpy(), t.canonical_order().to_numpy()):
        _same(torch.from_numpy(a), torch.from_numpy(b))
    # decode without the cached row ids recovers them from row_ptr
    import dataclasses

    td2 = csr_decode(dataclasses.replace(tc, row_ids=None))
    _same(td2.rows, tc.row_ids)


def test_empty_rows_row_ptr():
    r = np.array([2, 2, 5], np.int32)
    c = np.array([1, 0, 3], np.int32)
    t = coo_from_triplets(r, c, np.array([1.0, 2.0, 3.0]), (8, 4),
                          device="cpu")
    tc = csr_encode(t)
    assert tc.row_ptr.tolist() == [0, 0, 0, 2, 2, 2, 3, 3, 3]
    assert tc.col_ind.tolist() == [0, 1, 3]
    _same(tc.row_ptr, j_encode(JCOO.from_numpy(
        r, c, np.array([1.0, 2.0, 3.0]), shape=(8, 4))).row_ptr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_coo_pad_and_canonical_order(name):
    j, t = _pair(name, seed=2)
    jp, tp = j.pad(256), t.pad(256)
    assert tp.nnz_padded == jp.nnz_padded and tp.nnz == jp.nnz
    for a, b in ((tp.rows, jp.rows), (tp.cols, jp.cols), (tp.vals, jp.vals)):
        _same(a, b)
    jo, to = j.canonical_order(), t.canonical_order()
    for a, b in ((to.rows, jo.rows), (to.cols, jo.cols), (to.vals, jo.vals)):
        _same(a, b)


@pytest.mark.parametrize("n,nnz_per_row,bw,seed",
                         [(1000, 9, 64, 0), (4096, 10, 64, 0),
                          (300, 17, 5, 3), (129, 1, 200, 7)])
def test_synth_banded_bit_identical(n, nnz_per_row, bw, seed):
    j = jsynth.synth_banded(n, nnz_per_row=nnz_per_row, bandwidth=bw,
                            seed=seed)
    t = tsynth.synth_banded(n, nnz_per_row=nnz_per_row, bandwidth=bw,
                            seed=seed, device="cpu")
    assert t.shape == j.shape and t.nnz == j.nnz
    for a, b in zip(t.to_numpy(), j.to_numpy()):
        _same(torch.from_numpy(a), b)


@pytest.mark.parametrize("spec", ["synth:4096:40960", "synth:1000:5000",
                                  "synth:50:0"])
def test_parse_synth_spec_matches(spec):
    j = jsynth.parse_synth_spec(spec)
    t = tsynth.parse_synth_spec(spec, device="cpu")
    for a, b in zip(t.to_numpy(), j.to_numpy()):
        _same(torch.from_numpy(a), b)


@pytest.mark.parametrize("spec", ["synth:bad", "synth:1:2:3", "synth:0:5",
                                  "nope:1:2"])
def test_parse_synth_spec_errors_match(spec):
    with pytest.raises(ValueError) as je:
        jsynth.parse_synth_spec(spec)
    with pytest.raises(ValueError) as te:
        tsynth.parse_synth_spec(spec, device="cpu")
    assert str(te.value) == str(je.value)
