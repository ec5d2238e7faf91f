"""The port's sparse algebra (``ops/algebra.py``) against the JAX package's.

The same numpy-seeded COO (padded, with duplicates, in general and
symmetric storage, float32) goes through both packages. Every output is
held element for element, bit for bit: ``transpose`` (the entries, their
order with the padding last, the dropped symmetry claim), ``scale``,
``add`` (the concatenated triplets, expanded where the symmetries
differ), ``_as_general`` and ``matmul`` (scipy's product on both sides,
padded to ``pad_to``). ``row_sums``, ``col_sums`` and ``diagonal`` sum in
index order on both sides and are held bit for bit too, on random values
and on integer values (whose sums are exact in any order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.io.mtx import MMTypeCode as JTC
from smvp_toolkit_tpu.ops import algebra as jalg
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix as TCOO
from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode as TTC
from smvp_toolkit_tpu_torch.ops import algebra as talg


def _triplets(shape, nnz, seed, *, lower=False, integer=False):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, shape[0], nnz)
    c = rng.integers(0, shape[1], nnz)
    if lower:
        r, c = np.maximum(r, c), np.minimum(r, c)
    r[-3:], c[-3:] = r[0], c[0]  # duplicates
    v = (rng.integers(-9, 10, nnz).astype(np.float64) if integer
         else rng.standard_normal(nnz))
    return r.astype(np.int32), c.astype(np.int32), v


def _pair(shape, nnz, seed, *, symmetry="general", integer=False):
    r, c, v = _triplets(shape, nnz, seed, lower=symmetry != "general",
                        integer=integer)
    jtc = dataclasses.replace(JTC(), symmetry=symmetry)
    ttc = dataclasses.replace(TTC(), symmetry=symmetry)
    j = JCOO.from_numpy(r, c, v, shape=shape, typecode=jtc, pad_to=128)
    t = TCOO.from_numpy(r, c, v, shape=shape, typecode=ttc, pad_to=128,
                        device="cpu")
    return j, t


def _same_coo(t, j):
    """Every array, padding included, bit for bit; shape, nnz, symmetry."""
    assert t.shape == tuple(j.shape) and t.nnz == j.nnz
    assert t.typecode.symmetry == j.typecode.symmetry
    assert np.array_equal(t.rows.numpy(), np.asarray(j.rows))
    assert np.array_equal(t.cols.numpy(), np.asarray(j.cols))
    tv, jv = t.vals.numpy(), np.asarray(j.vals)
    assert tv.dtype == jv.dtype and tv.tobytes() == jv.tobytes()


def _same(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    assert t.tobytes() == j.tobytes()


SHAPES = [(70, 70), (50, 90), (130, 40)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("fn", ["row_sums", "col_sums", "diagonal"])
def test_sums_and_diagonal(shape, integer, fn):
    j, t = _pair(shape, 400, 1, integer=integer)
    _same(getattr(talg, fn)(t), getattr(jalg, fn)(j))


@pytest.mark.parametrize("shape,symmetry", [
    *((s, "general") for s in SHAPES), ((70, 70), "symmetric")])
def test_transpose(shape, symmetry):
    j, t = _pair(shape, 400, 2, symmetry=symmetry)
    out = talg.transpose(t)
    _same_coo(out, jalg.transpose(j))
    assert out.typecode.symmetry == "general"


@pytest.mark.parametrize("alpha", [0.5, -3.0, 1.0 / 3.0])
def test_scale(alpha):
    j, t = _pair((70, 70), 400, 3)
    _same_coo(talg.scale(t, alpha), jalg.scale(j, alpha))


@pytest.mark.parametrize("sym_a,sym_b", [("general", "general"),
                                         ("symmetric", "symmetric"),
                                         ("symmetric", "general"),
                                         ("general", "skew-symmetric")])
@pytest.mark.parametrize("beta", [1.0, -0.25])
def test_add(sym_a, sym_b, beta):
    ja, ta = _pair((70, 70), 300, 4, symmetry=sym_a)
    jb, tb = _pair((70, 70), 200, 5, symmetry=sym_b)
    _same_coo(talg.add(ta, tb, beta), jalg.add(ja, jb, beta))


def test_add_shape_mismatch():
    _, ta = _pair((70, 70), 100, 4)
    _, tb = _pair((50, 90), 100, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        talg.add(ta, tb)


@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
def test_as_general(symmetry):
    j, t = _pair((70, 70), 300, 6, symmetry=symmetry)
    out = talg._as_general(t)
    _same_coo(out, jalg._as_general(j))
    assert (out is t) == (symmetry == "general")


@pytest.mark.parametrize("sym_a", ["general", "symmetric"])
@pytest.mark.parametrize("pad_to", [128, 256])
def test_matmul(sym_a, pad_to):
    ja, ta = _pair((70, 70), 300, 7, symmetry=sym_a)
    jb, tb = _pair((70, 40), 250, 8)
    _same_coo(talg.matmul(ta, tb, pad_to=pad_to),
              jalg.matmul(ja, jb, pad_to=pad_to))


def test_matmul_inner_dimensions():
    _, ta = _pair((50, 90), 100, 4)
    with pytest.raises(ValueError, match="inner dimensions"):
        talg.matmul(ta, ta)


def test_symmetric_part_as_the_cli_builds_it():
    """(A + Aᵀ)/2 of a symmetric-stored A, the -amg methods' operator:
    the same triplets as the JAX CLI's, and a symmetric matrix."""
    j, t = _pair((70, 70), 300, 9, symmetry="symmetric")
    jg, tg = jalg._as_general(j), talg._as_general(t)
    jsym = jalg.scale(jalg.add(jg, jalg.transpose(jg)), 0.5)
    tsym = talg.scale(talg.add(tg, talg.transpose(tg)), 0.5)
    _same_coo(tsym, jsym)
    r, c, v = tsym.to_numpy()
    dense = np.zeros((70, 70))
    np.add.at(dense, (r, c), v.astype(np.float64))
    assert np.array_equal(dense, dense.T)
