"""TJDS: the port's codec and SpMVs against the JAX package's.

Encode arrays (``vals``, ``row_ind``, ``start_pos``, ``perm``, ``offsets``,
``num_diags``) bit-identical to the JAX encoder's on the same padded COO;
decode bit-exact; ``footprint_bytes`` equal. ``spmv_tjds`` (plain
PyTorch) against the JAX ``spmv_tjds`` and ``spmv_tjds_sell`` (the SELL
kernels' plain versions on the CPU) against the JAX ``spmv_tjds_pallas``
(interpret mode, autotune pinned off so both plan at chunk 2048), within
1e-6 of max |y|. The C reference's TJDS goldens are corrupt (SURVEY §B2),
so the JAX package is the reference.
"""

from __future__ import annotations

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.tjds import tjds_decode as j_decode
from smvp_toolkit_tpu.formats.tjds import tjds_encode as j_encode
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops import spmv_xla
from smvp_toolkit_tpu.utils.synth import synth_banded
from smvp_toolkit_tpu_torch.formats.tjds import tjds_decode, tjds_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops import spmv_torch

from conftest import random_coo

TOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _triplets(name):
    if name == "banded":
        r, c, v = synth_banded(3000, nnz_per_row=7, seed=3).to_numpy()
        return r, c, np.asarray(v, np.float64), (3000, 3000)
    rng = np.random.RandomState(9)
    if name == "rect-empty":  # empty rows and columns, wide
        r, c, v = random_coo(rng, 700, 1900, 5000)
        r = (r // 3) * 3
        return r, c, v, (700, 1900)
    if name == "dups":
        r, c, v = random_coo(rng, 400, 300, 6000, allow_duplicates=True)
        return r, c, v, (400, 300)
    if name == "nnz0":
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0), (50, 40)
    raise AssertionError(name)


NAMES = ["banded", "rect-empty", "dups", "nnz0"]


def _pair(name, dtype="float32", pad=128):
    r, c, v, shape = _triplets(name)
    j = JCOO.from_numpy(r, c, v, shape=shape, dtype=getattr(jnp, dtype))
    t = coo_from_triplets(r, c, v, shape, dtype=getattr(torch, dtype),
                          device="cpu")
    return j.pad(pad), t.pad(pad)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_encode_arrays_bit_identical(name, dtype):
    jc, tc = _pair(name, dtype)
    j, t = j_encode(jc), tjds_encode(tc)
    for f in ("vals", "row_ind", "start_pos", "perm", "offsets"):
        a, b = _np(getattr(t, f)), _np(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert t.num_diags == int(j.num_diags)
    assert (t.shape, t.nnz, t.diag_bound) == (j.shape, j.nnz, j.diag_bound)
    assert t.footprint_bytes() == j.footprint_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_decode_round_trip_exact(name):
    jc, tc = _pair(name)
    d = tjds_decode(tjds_encode(tc))
    r, c, v = d.canonical_order().to_numpy()
    R, C, V = tc.canonical_order().to_numpy()
    assert np.array_equal(r, R) and np.array_equal(c, C)
    assert v.tobytes() == V.tobytes()
    # and equal to the JAX decode, entry for entry in storage order
    jd = j_decode(j_encode(jc))
    for a, b in ((d.rows, jd.rows), (d.cols, jd.cols), (d.vals, jd.vals)):
        assert _np(a).tobytes() == _np(b).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_spmv_tjds_matches_spmv_xla(name):
    jc, tc = _pair(name)
    x = np.random.default_rng(4).standard_normal(tc.shape[1]).astype(
        np.float32)
    y_t = spmv_torch.spmv_tjds(tjds_encode(tc), torch.from_numpy(x))
    y_j = spmv_xla.spmv_tjds(j_encode(jc), jnp.asarray(x))
    assert y_t.dtype == torch.float32 and y_t.shape == (tc.shape[0],)
    assert _rel(y_t.numpy(), y_j) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["banded", "rect-empty", "dups"])
def test_spmv_tjds_sell_matches_pallas(monkeypatch, name, dtype):
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    jc, tc = _pair(name, dtype)
    x = np.random.default_rng(6).standard_normal(tc.shape[1]).astype(
        np.float32)
    t = tjds_encode(tc)
    y_t = tsp.spmv_tjds_sell(t, torch.from_numpy(x).to(getattr(torch, dtype)))
    y_j = jsp.spmv_tjds_pallas(j_encode(jc),
                               jnp.asarray(x, getattr(jnp, dtype)))
    assert _rel(y_t.numpy(), y_j) <= TOL
    op = tsp.sell_op_tjds(t)
    assert op is tsp.sell_op_tjds(t)  # cached per matrix
    assert op.value_dtype == getattr(torch, dtype)


def test_tjds_and_csr_operators_agree():
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode

    _, tc = _pair("rect-empty")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        tc.shape[1]).astype(np.float32))
    y_t = tsp.spmv_tjds_sell(tjds_encode(tc), x)
    y_c = tsp.spmv_csr_sell(csr_encode(tc), x)
    assert _rel(y_t.numpy(), y_c.numpy()) <= TOL


def test_tjds_operator_cache_is_weak():
    _, tc = _pair("banded")
    t = tjds_encode(tc)
    op = tsp.sell_op_tjds(t)
    n = len(tsp._CACHE)
    del t, op
    gc.collect()
    assert len(tsp._CACHE) == n - 1
