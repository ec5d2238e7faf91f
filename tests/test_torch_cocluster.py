"""The port's co-clustering against the JAX package's, and the co-clustered
operator against the JAX one.

``ops/cocluster.py`` of both packages on the same coordinates (numpy
seeds): maps, objectives, moves, init and padded shape equal element for
element (the port's ``csrc/cocluster.cpp`` against the JAX package's
built ``libcocluster.so``), for every init with default and explicit
passes and radii; the helpers likewise; out-of-range inputs rejected as
the JAX library rejects them. ``CoClusteredSellSpMV`` of both packages
on the same matrix and chunk: ``__call__`` and ``bench_loop`` within
1e-6 of max |y| (the JAX operator runs its Pallas kernels in interpret
mode; the port its plain versions on the CPU), and the permutations
equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.ops import cocluster as jc
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix as TCOO
from smvp_toolkit_tpu_torch.interop import plan_fields
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops import cocluster as tc
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _matrix(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "banded":
        n, nnz, band = 1500, 9000, 200
        r = rng.integers(0, n, nnz)
        c = np.clip(r + rng.integers(-band, band + 1, nnz), 0, n - 1)
        shape = (n, n)
    elif kind == "scattered":  # fragmentation: the signature init wins
        n, m, nnz = 2000, 2500, 3000
        r, c = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
        shape = (n, m)
    else:  # rectangular, empty rows and columns
        n, m, nnz = 700, 1900, 6000
        r = rng.integers(0, n // 2, nnz) * 2
        c = np.clip(r * 2 + rng.integers(-300, 301, nnz), 0, m - 1)
        shape = (n, m)
    return r.astype(np.int64), c.astype(np.int64), rng.standard_normal(nnz), \
        shape


KINDS = ("banded", "scattered", "rect")
OPTIONS = {"default": {},
           "explicit": dict(passes=3, col_radius=4, row_radius=2, alpha=1,
                            row_slack=0.1, col_slack=0.0)}


def _same(a, b):
    assert np.array_equal(a.row_map, b.row_map)
    assert np.array_equal(a.col_map, b.col_map)
    assert a.row_map.dtype == b.row_map.dtype == np.int64
    assert tuple(a.shape_padded) == tuple(b.shape_padded)
    assert (a.s_true, a.s_true_natural, a.moves, a.init) == (
        b.s_true, b.s_true_natural, b.moves, b.init)


@pytest.mark.parametrize("options", sorted(OPTIONS))
@pytest.mark.parametrize("init", ["natural", "signature", "auto"])
@pytest.mark.parametrize("kind", KINDS)
def test_cocluster_equals_jax(kind, init, options):
    r, c, _, shape = _matrix(kind)
    kw = dict(OPTIONS[options], init=init)
    ref = jc.cocluster(r, c, shape, **kw)
    got = tc.cocluster(r, c, shape, **kw)
    _same(got, ref)
    assert got.s_true <= got.s_true_natural
    assert np.array_equal(got.row_inverse(), ref.row_inverse())
    assert np.array_equal(got.col_inverse(), ref.col_inverse())
    assert got.occupancy(len(r)) == ref.occupancy(len(r))


def test_cocluster_memo_returns_the_same_result():
    r, c, _, shape = _matrix("banded")
    a = tc.cocluster(r, c, shape, passes=2)
    assert tc.cocluster(r.astype(np.int32), c, shape, passes=2) is a
    b = tc.cocluster(r, c, shape, passes=3)
    assert b is not a and len(tc._MEMO) <= tc._MEMO_SIZE
    with pytest.raises(ValueError):  # read-only maps: the memo is shared
        a.row_map[0] = 0


@pytest.mark.parametrize("kind", KINDS)
def test_helpers_equal_jax(kind):
    r, c, _, (n, m) = _matrix(kind)
    for items, groups in ((n, 17), (m, 3), (1, 1), (0, 4)):
        assert np.array_equal(tc._spread_assign(items, groups),
                              jc._spread_assign(items, groups))
    assert np.array_equal(tc._signature_row_order(r, c, n),
                          jc._signature_row_order(r, c, n))
    assert np.array_equal(tc._signature_row_order(r, c, n, k=2),
                          jc._signature_row_order(r, c, n, k=2))
    assign = np.random.default_rng(1).integers(0, 40, n).astype(np.int32)
    assert np.array_equal(tc._group_map(assign, 40),
                          jc._group_map(assign, 40))


@pytest.mark.parametrize("kind", KINDS)
def test_objective_equals_jax(kind):
    r, c, _, (n, m) = _matrix(kind)
    rng = np.random.default_rng(2)
    ra = rng.integers(0, -(-n // 128) + 3, n).astype(np.int32)
    ca = rng.integers(0, -(-m // 128) + 1, m).astype(np.int32)
    assert tc.cocluster_objective(r, c, (n, m)) == jc.cocluster_objective(
        r, c, (n, m))
    assert tc.cocluster_objective(r, c, (n, m), ra, ca) == \
        jc.cocluster_objective(r, c, (n, m), ra, ca)


def test_out_of_range_inputs_rejected_as_the_jax_library_does():
    bad = np.array([-1], dtype=np.int32)
    ok = np.array([0], dtype=np.int32)
    one = np.array([0], np.int64)
    cases = [
        (np.array([5], np.int64), one, (2, 2), None, None),  # row >= n
        (one, np.array([3], np.int64), (2, 2), None, None),  # col >= m
        (one, one, (1, 1), bad, ok),                          # row assign
        (one, one, (1, 1), ok, bad),                          # col assign
    ]
    lib = tc._lib()
    for r, c, shape, ra, ca in cases:
        assert jc.cocluster_objective(r, c, shape, ra, ca) == -1
        with pytest.raises(ValueError, match="rejected"):
            tc.cocluster_objective(r, c, shape, ra, ca)
        # the port's library itself answers -1, as the JAX one does
        n, m = shape
        ra = (np.zeros(n, np.int32) if ra is None else ra)
        ca = (np.zeros(m, np.int32) if ca is None else ca)
        assert lib.cocluster_objective(r, c, len(r), n, m, ra, ca, 1, 1) == -1
    # refinement: a coordinate out of range
    r, c = np.array([0, 7], np.int64), np.array([0, 1], np.int64)
    assert jc.cocluster(r, c, (4, 4)) is None
    with pytest.raises(ValueError, match="rejected"):
        tc.cocluster(r, c, (4, 4))


def test_empty_matrix_gives_none_in_both():
    e = np.zeros(0, np.int64)
    assert jc.cocluster(e, e, (10, 10)) is None
    assert tc.cocluster(e, e, (10, 10)) is None
    assert tc.cocluster_plan(e, e, np.zeros(0), (10, 10)) is None


def test_library_is_listed_and_built_by_the_loader():
    assert "cocluster" in _build.sources()
    lib = tc._lib()
    assert lib is _build.load("cocluster", tc._SIGNATURES)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("chunk", [None, 2048, 256])
@pytest.mark.parametrize("kind", ["banded", "rect"])
def test_cocluster_plan_equals_jax(kind, chunk, bf16):
    r, c, v, shape = _matrix(kind)
    jres, jplan, jvmem = jc.cocluster_plan(r, c, v, shape, chunk=chunk,
                                           bf16=bf16, passes=4)
    tres, tplan, tvmem = tc.cocluster_plan(r, c, v, shape, chunk=chunk,
                                           bf16=bf16, passes=4)
    _same(tres, jres)
    assert tvmem == jvmem
    for (name, a), b in zip(plan_fields(tplan).items(),
                            plan_fields(jplan).values()):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), name
        else:
            assert a == b, name
    # the process keeps the result: a second plan reuses it
    again = tc.cocluster_plan(r, c, v, shape, chunk=chunk, bf16=bf16,
                              passes=4)
    assert again[0] is tres


@pytest.fixture(scope="module")
def cc_pair():
    r, c, v, shape = _matrix("rect")
    return r, c, v, shape


@pytest.mark.parametrize("chunk", [2048, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_coclustered_operator_matches_jax(cc_pair, dtype, chunk):
    r, c, v, shape = cc_pair
    tdt, jdt = DTYPES[dtype]
    jop = jsp.CoClusteredSellSpMV(
        JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32), v,
                        shape=shape), value_dtype=jdt, chunk=chunk, passes=4)
    top = tsp.CoClusteredSellSpMV(
        TCOO.from_numpy(r, c, v, shape=shape, device="cpu"),
        value_dtype=tdt, chunk=chunk, passes=4)
    _same(top.result, jop.result)
    assert top.inner.plan.chunk == jop.inner.plan.chunk
    assert top.occupancy == pytest.approx(jop.occupancy, rel=0, abs=0)
    x = np.random.default_rng(4).standard_normal(shape[1]).astype(np.float32)
    xt = torch.from_numpy(x)
    xp_t = top.to_permuted(xt)
    xp_j = jop.to_permuted(jnp.asarray(x))
    assert np.array_equal(xp_t.numpy(), np.asarray(xp_j))
    assert xp_t.shape == (top.result.shape_padded[1],)
    y_t, y_j = top(xt), jop(jnp.asarray(x))
    assert y_t.shape == (shape[0],)
    assert _rel(y_t.numpy(), y_j) <= TOL
    yb_t = top.bench_loop(xp_t, 2)
    yb_j = jop.bench_loop(xp_j, 2)
    assert yb_t.shape == (top.result.shape_padded[0],)
    assert _rel(yb_t.numpy(), yb_j) <= TOL
    assert torch.equal(top.from_permuted(yb_t), yb_t[top._row_map])
    # the natural y through the permuted loop
    assert _rel(top.from_permuted(yb_t).numpy(), y_j) <= TOL


def test_coclustered_operators_share_one_cocluster(cc_pair):
    r, c, v, shape = cc_pair
    coo = TCOO.from_numpy(r, c, v, shape=shape, device="cpu")
    f32 = tsp.CoClusteredSellSpMV(coo, passes=4)
    assert f32.inner.plan.chunk == tsp._auto_plan(
        f32.result.row_map[r], f32.result.col_map[c], v,
        f32.result.shape_padded).chunk
    bf = tsp.sell_op_coo_coclustered(coo, value_dtype=torch.bfloat16,
                                     passes=4)
    assert bf.result is f32.result and bf.inner.value_dtype == torch.bfloat16
    assert bf.inner.bench_route == "relsl"


def test_coclustered_operator_without_library_names_the_build(
        cc_pair, monkeypatch):
    r, c, v, shape = cc_pair

    def refuse(name, signatures):
        raise _build.KernelBuildError("no host C++ compiler found")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tc, "_MEMO", {})
    coo = TCOO.from_numpy(r, c, v, shape=shape, device="cpu")
    with pytest.raises(RuntimeError, match=r"_build\.build\(\['cocluster'\]"):
        tsp.CoClusteredSellSpMV(coo, passes=4)


def test_coclustered_operator_refuses_an_empty_matrix():
    e = np.zeros(0, np.int64)
    coo = TCOO.from_numpy(e, e, np.zeros(0), shape=(300, 300), device="cpu")
    with pytest.raises(ValueError, match="non-zeros"):
        tsp.CoClusteredSellSpMV(coo)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())
