"""K8's walk on staged slice metadata against the JAX package.

K8 (``csrc/sell_df64.cu``) gives each block ``kDf64Slices`` slices and
each thread one row. In passes of up to 128 entries a slice, the block
stages each live sublane of the slice's index (``slice_index``) once: its
slot offset ``s·128`` and its x column base ``(tile_base[s / chunk] +
rel)·128``, rel from the merged word. Each thread then walks the staged
entries ``kDf64Unroll`` at a time, their loads together, and adds the
terms to its row's float64 sum strictly in the index's order. ``_stage``
and ``_walk`` below are that in numpy. On the small plans, the hub-row
plan (258 live sublanes in one slice, three passes; 8 empty slices), a
plan with empty slices and one whose slices straddle chunks, every staged
entry equals the per-step value the row walk computed before (from the
plan's own rel and tile_base), the emulated sums equal ``sell_df64_plain``
bit for bit and lie within 5e-14 of max |y| of the float64 oracle (the
JAX suite's bound), and the JAX ``SellDf64SpMV`` (interpret mode), itself
within about 5e-14 of the oracle, agrees within twice that.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops.precision import df_split as j_split
from smvp_toolkit_tpu.ops.precision import df_to_f64 as j_to_f64
from smvp_toolkit_tpu.ops.spmv_df64 import SellDf64SpMV as JDf64
from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64

import test_torch_df64 as df64_cases
import torch_kcol_plans as kcol

TOL = 5e-14
LANES = 128
SRC = open(D.__file__.rsplit("/", 2)[0] + "/csrc/sell_df64.cu").read()


def _constant(name):
    return int(SRC.split(f"constexpr int {name} = ")[1].split(";")[0])


SLICES = _constant("kDf64Slices")
UNROLL = _constant("kDf64Unroll")


def _triplets(name):
    """(rows, cols, float64 values, shape, x64, chunk)."""
    if name in df64_cases.CASES:
        return df64_cases._case(name)
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "hub-row":
        r, c, v, shape, chunk = kcol.hub_row_triplets("relsl")
        return r, c, v, shape, rng.randn(shape[1]), chunk
    if name == "empty-slices":  # rows only in every third slice
        n, m, nnz = 2048, 1500, 9000
        r = (rng.choice(np.arange(0, n // 128, 3), nnz) * 128
             + rng.randint(0, 128, nnz))
        c = rng.randint(0, m, nnz)
        return r, c, rng.randn(nnz), (n, m), rng.randn(m), 256
    assert name == "straddle"  # chunk 64: a slice's sublanes in 6 chunks
    n, m, nnz = 900, 800, 12000
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    v = rng.randn(nnz) * np.exp2(rng.randint(-8, 8, nnz))
    return r, c, v, (n, m), rng.randn(m), 64


NAMES = [*df64_cases.CASES, "hub-row", "empty-slices", "straddle"]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    r, c, v64, shape, x64, chunk = _triplets(request.param)
    top = D.SellDf64SpMV.from_coo_f64(r, c, v64, shape, chunk=chunk,
                                      device="cpu")
    return request.param, (r, c, v64, shape, x64, chunk), top


def _stage(top, slices=SLICES):
    """Per slice, the staged entries in walk order: (slot offset, column
    base) as the block writes them, pass by pass, group by group."""
    relsl = top.relsl.numpy().astype(np.int64) & 0xFFFFFFFF
    tile_base = top.tile_base.numpy().astype(np.int64)
    ptr = top.slice_ptr.numpy().astype(np.int64)
    sub = top.sublanes.numpy().astype(np.int64)
    chunk, ns = top.plan.chunk, top.plan.n_slices
    staged = [[] for _ in range(ns)]
    for g in range(-(-ns // slices)):
        mine = [k for k in range(g * slices, (g + 1) * slices) if k < ns]
        most = max(ptr[k + 1] - ptr[k] for k in mine)
        for base in range(0, most, LANES):
            for k in mine:  # thread t stages entry base + t % 128
                e = np.arange(base, min(base + LANES, ptr[k + 1] - ptr[k]))
                s = sub[ptr[k] + e]
                tile = tile_base[s // chunk] + (relsl[s] & 511)
                staged[k] += list(zip(s * LANES, tile * LANES))
    return staged


def _per_step(top):
    """Per slice, what the row walk computed at each step from the plan:
    (s·128, (tile_base[s / chunk] + rel_tile[s])·128), in index order."""
    plan = top.plan
    ptr, sub = D.slice_index(plan)
    out = []
    for k in range(plan.n_slices):
        s = sub[ptr[k]:ptr[k + 1]].astype(np.int64)
        tile = (plan.tile_base.astype(np.int64)[s // plan.chunk]
                + plan.rel_tile.reshape(-1)[s])
        out.append(list(zip(s * LANES, tile * LANES)))
    return out


def _walk(top, xh, xl, staged, unroll=UNROLL):
    """Each row's float64 sum over its slice's staged entries, ``unroll``
    steps at a time, each term ``vh·xh + e`` (``e = vh·xl (+ vl·xh +
    vl·xl)``) added in order; the pair split once."""
    vh = top.vals_hi.numpy().reshape(-1).astype(np.float64)
    vl = (None if top.vals_lo is None
          else top.vals_lo.numpy().reshape(-1).astype(np.float64))
    li = top.lidx.numpy().reshape(-1).astype(np.int64)
    xh, xl = xh.astype(np.float64), xl.astype(np.float64)
    lane = np.arange(LANES)
    acc = np.zeros((top.plan.n_slices, LANES))
    for k, entries in enumerate(staged):
        for j0 in range(0, len(entries), unroll):
            for off, colbase in entries[j0:j0 + unroll]:
                i = off + lane
                col = colbase + li[i]
                e = vh[i] * xl[col]
                if vl is not None:
                    e = e + vl[i] * xh[col]
                    e = e + vl[i] * xl[col]
                acc[k] = acc[k] + (vh[i] * xh[col] + e)
    y = acc.reshape(-1)
    hi = y.astype(np.float32)
    return hi, (y - hi.astype(np.float64)).astype(np.float32)


def test_plans_cover_the_walks_edges():
    """The hub-row plan needs three passes and has empty slices; the
    straddle plan has slices over several chunks."""
    def counts(name):
        r, c, v, shape, _, chunk = _triplets(name)
        top = D.SellDf64SpMV.from_coo_f64(r, c, v, shape, chunk=chunk,
                                          device="cpu")
        ptr, sub = D.slice_index(top.plan)
        chunks = [len(np.unique(sub[ptr[k]:ptr[k + 1]] // top.plan.chunk))
                  for k in range(top.plan.n_slices)]
        return np.diff(ptr), max(chunks)

    n, _ = counts("hub-row")
    assert n.max() == 258 > 2 * LANES and (n == 0).sum() == 8
    n, _ = counts("empty-slices")
    assert (n == 0).sum() >= 8
    _, most = counts("straddle")
    assert most >= 2


@pytest.mark.parametrize("slices", [1, 2])
def test_staged_entries_equal_the_per_step_values(case, slices):
    _, _, top = case
    assert _stage(top, slices) == _per_step(top)


@pytest.mark.parametrize("unroll", [1, UNROLL, 8])
def test_walk_equals_plain_bit_for_bit(case, unroll):
    _, (_, _, _, _, x64, _), top = case
    xh, xl = df_split(x64, device="cpu")
    planes = top._planes(xh, xl)
    ph, pl = D.sell_df64_plain(*planes, n_slices=top.plan.n_slices,
                               chunk=top.plan.chunk)
    hi, lo = _walk(top, planes[-2].numpy(), planes[-1].numpy(),
                   _stage(top), unroll)
    assert np.array_equal(hi.view(np.uint32), ph.numpy().view(np.uint32))
    assert np.array_equal(lo.view(np.uint32), pl.numpy().view(np.uint32))


def test_walk_matches_jax(case):
    name, (r, c, v64, shape, x64, chunk), top = case
    xh, xl = df_split(x64, device="cpu")
    planes = top._planes(xh, xl)
    hi, lo = _walk(top, planes[-2].numpy(), planes[-1].numpy(), _stage(top))
    y = df_to_f64(torch.from_numpy(hi), torch.from_numpy(lo))[: shape[0]]
    jop = JDf64.from_coo_f64(r, c, v64, shape, chunk=chunk)
    yj = j_to_f64(*jop(*j_split(x64)))
    oracle = df64_cases._oracle(r, c, v64, x64, shape[0])
    if name == "cancel":  # the pair holds 48 bits a value (test_df64)
        assert df64_cases._rel(y, oracle) < 1e-5
        assert df64_cases._rel(y, yj) < 1e-5
    else:
        # both within the JAX suite's 5e-14 of the float64 oracle; the
        # JAX kernel reaches 5.03e-14 on the hub row, the walk 1.7e-15
        assert df64_cases._rel(y, oracle) <= TOL
        assert df64_cases._rel(y, yj) <= 2 * TOL


def test_kernel_constants_are_instantiated():
    assert SLICES in (1, 2) and UNROLL in (1, 2, 4, 8)
    assert "launch_df64<kDf64Unroll, kDf64Slices," in SRC
    assert "launch_bench_df64<kDf64Unroll, kDf64Slices," in SRC
