"""Double-float SELL SpMV: the port's K8 (plain version on the CPU) against
the JAX package's Pallas df64 kernel in interpret mode.

The cases of ``tests/test_df64_pallas.py``: random float64 values at
chunks 512 and 256, float32 values (no lo plane), cancelling rows, the
edge scales, and the refusal of streamed plans and of windows over 511
tiles. Both operators run the same planes (``from_coo_f64`` builds equal
planes in both packages; ``interop.df64_from_arrays`` carries the JAX
operator's over) and both are held to the float64 oracle: <= 5e-14 of
max |y| (``tests/test_df64_pallas.py:37``). The port's float64 row sums
make the edge scales exact, where the JAX kernel degrades outside its
clamp band. ``bench_loop`` equals one call bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops.precision import df_split as j_split
from smvp_toolkit_tpu.ops.precision import df_to_f64 as j_to_f64
from smvp_toolkit_tpu.ops.spmv_df64 import SellDf64SpMV as JDf64
from smvp_toolkit_tpu_torch.interop import (
    df64_from_arrays,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64

TOL = 5e-14


def _oracle(r, c, v64, x64, n):
    y = np.zeros(n)
    np.add.at(y, r, v64 * x64[c])
    return y


def _rel(y, ref):
    return np.abs(y - ref).max() / (np.abs(ref).max() + 1e-300)


def _case(name):
    """(rows, cols, float64 values, shape, x64, chunk)."""
    if name.startswith("random"):
        seed, chunk = (0, 512) if name == "random-c512" else (1, 256)
        rng = np.random.RandomState(seed)
        n, m, nnz = 900, 800, 12000
        r = rng.randint(0, n, nnz).astype(np.int64)
        c = rng.randint(0, m, nnz).astype(np.int64)
        v64 = rng.randn(nnz) * np.exp2(rng.randint(-8, 8, nnz))
        return r, c, v64, (n, m), rng.randn(m), chunk
    if name == "f32-values":
        rng = np.random.RandomState(2)
        n, m, nnz = 500, 500, 6000
        r = rng.randint(0, n, nnz).astype(np.int64)
        c = rng.randint(0, m, nnz).astype(np.int64)
        v64 = rng.randn(nnz).astype(np.float32).astype(np.float64)
        return r, c, v64, (n, m), rng.randn(m), 256
    assert name == "cancel"
    n = 256
    rng = np.random.RandomState(3)
    base = rng.randn(n // 2) * 1e4
    r = np.repeat(np.arange(n // 2), 2).astype(np.int64)
    c = np.arange(n).astype(np.int64)
    v64 = np.empty(n)
    v64[0::2] = base
    v64[1::2] = -base + 1e-4 * rng.randn(n // 2)
    return r, c, v64, (n // 2, n), np.ones(n), 8


CASES = ["random-c512", "random-c256", "f32-values", "cancel"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    r, c, v64, shape, x64, chunk = _case(request.param)
    jop = JDf64.from_coo_f64(r, c, v64, shape, chunk=chunk)
    top = D.SellDf64SpMV.from_coo_f64(r, c, v64, shape, chunk=chunk,
                                      device="cpu")
    return request.param, (r, c, v64, shape, x64), jop, top


def test_planes_bit_equal_to_jax(case):
    name, _, jop, top = case
    assert (jop.vals_lo is None) == (top.vals_lo is None)
    assert (top.vals_lo is None) == (name == "f32-values")
    assert np.array_equal(np.asarray(jop.vals_hi).view(np.uint32),
                          top.vals_hi.numpy().view(np.uint32))
    if top.vals_lo is not None:
        assert np.array_equal(np.asarray(jop.vals_lo).view(np.uint32),
                              top.vals_lo.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jop.lidx).astype(np.int32),
                          top.lidx.numpy().astype(np.int32))
    assert top.lidx.dtype == (torch.int8 if top.plan.chunk % 32 == 0
                              else torch.int32)
    assert np.array_equal(np.asarray(jop.relsl).reshape(-1),
                          top.relsl.numpy())
    for f, v in plan_fields(jop.plan).items():
        w = getattr(top.plan, f)
        assert (np.array_equal(v, w) if isinstance(v, np.ndarray)
                else v == w), f


def test_call_matches_jax_and_oracle(case):
    name, (r, c, v64, shape, x64), jop, top = case
    launches = D.sell_df64.launches
    yj = j_to_f64(*jop(*j_split(x64)))
    yh, yl = top(*df_split(x64, device="cpu"))
    assert D.sell_df64.launches == launches  # the CPU launches nothing
    assert yh.dtype == yl.dtype == torch.float32
    assert yh.shape == (shape[0],)
    yt = df_to_f64(yh, yl)
    oracle = _oracle(r, c, v64, x64, shape[0])
    if name == "cancel":
        # The pair holds 48 bits of each value: 2^-48 of 1e4 against sums
        # of about 1e-4, the bound of the JAX suite for its kernel (whose
        # design bound is 2^-49 of the chunk product scale); float32 keeps
        # nothing. On the values the pair holds the port is exact.
        held = top.plan.vals.astype(np.float64) + top.vals_lo.numpy()
        held_oracle = np.zeros(top.plan.n_slices * 128)
        live = held != 0  # dead and padding slots hold 0
        rows = (top.plan.slice_of.reshape(-1)[:, None] * 128
                + np.arange(128))
        np.add.at(held_oracle, rows[live], held[live])  # x = 1
        assert _rel(yt, held_oracle[: shape[0]]) <= TOL
        assert _rel(yt, oracle) < 1e-5 and _rel(yj, oracle) < 1e-5
    else:
        assert _rel(yt, oracle) <= TOL
        assert _rel(yj, oracle) <= TOL
        assert _rel(yt, yj) <= 2 * TOL


def test_bench_loop_equals_call(case):
    _, (_, _, _, _, x64), _, top = case
    xh, xl = df_split(x64, device="cpu")
    y1 = top(xh, xl)
    y3 = top.bench_loop(xh, xl, 3)
    assert torch.equal(y1[0], y3[0]) and torch.equal(y1[1], y3[1])
    with pytest.raises(ValueError):
        top.bench_loop(xh, xl, 0)


def test_x_lo_defaults_to_zero(case):
    _, (_, _, _, _, x64), _, top = case
    xh = torch.from_numpy(x64.astype(np.float32))
    a, b = top(xh), top(xh, torch.zeros_like(xh))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_interop_carries_the_jax_planes(case):
    _, (_, _, _, _, x64), jop, top = case
    lo = None if jop.vals_lo is None else np.asarray(jop.vals_lo)
    op = df64_from_arrays(plan_fields(jop.plan), lo, device="cpu")
    assert op.device.type == "cpu" and (op.vals_lo is None) == (lo is None)
    for a, b in ((op.vals_hi, top.vals_hi), (op.relsl, top.relsl),
                 (op.slice_ptr, top.slice_ptr), (op.sublanes, top.sublanes)):
        assert torch.equal(a, b)
    xh, xl = df_split(x64, device="cpu")
    y, y2 = op(xh, xl), top(xh, xl)
    assert torch.equal(y[0], y2[0]) and torch.equal(y[1], y2[1])


def test_plain_sums_in_the_kernels_order(case):
    """The plain version is K8's arithmetic in K8's order: a numpy walk of
    each slice's live sublanes through the index, each slot's
    ``vh·xh + (vh·xl + vl·xh + vl·xl)`` added left to right in float64,
    gives the same bits; and it stays within 1e-15 of the planes' float64
    value."""
    _, (_, _, _, _, x64), _, top = case
    plan = top.plan
    vh = plan.vals.astype(np.float64)
    vl = (None if top.vals_lo is None
          else top.vals_lo.numpy().astype(np.float64))
    ptr, sub = D.slice_index(plan)
    xh_t, xl_t = df_split(x64, device="cpu")
    xh = np.zeros(plan.n_coltiles * 128)
    xl = np.zeros(plan.n_coltiles * 128)
    xh[: len(x64)], xl[: len(x64)] = xh_t.numpy(), xl_t.numpy()
    acc = np.zeros((plan.n_slices, 128))
    for sl in range(plan.n_slices):
        for s in sub[ptr[sl]:ptr[sl + 1]]:
            col = (plan.tile_base[s // plan.chunk] + plan.rel_tile[s, 0]) \
                * 128 + plan.lane_idx[s]
            e = vh[s] * xl[col]
            if vl is not None:
                e = e + vl[s] * xh[col]
                e = e + vl[s] * xl[col]
            acc[sl] = acc[sl] + (vh[s] * xh[col] + e)
    y = acc.reshape(-1)
    hi, lo = top(xh_t, xl_t)
    n = plan.shape[0]
    assert np.array_equal(hi.numpy(), y.astype(np.float32)[:n])
    assert np.array_equal(
        lo.numpy(), (y - y.astype(np.float32)).astype(np.float32)[:n])
    held = vh if vl is None else vh + vl
    exact = np.zeros(plan.n_slices * 128)
    for s in sub:
        col = (plan.tile_base[s // plan.chunk] + plan.rel_tile[s, 0]) * 128 \
            + plan.lane_idx[s]
        np.add.at(exact, plan.slice_of.reshape(-1)[s] * 128 + np.arange(128),
                  held[s] * (xh[col] + xl[col]))
    assert _rel(df_to_f64(hi, lo), exact[:n]) <= 1e-15


def test_slice_index_covers_live_sublanes_in_plan_order():
    r, c, v64, shape, _, chunk = _case("random-c256")
    plan = jplan.build_sell_plan(r, c, v64, shape, chunk=chunk)
    tp = plan_from_arrays(plan_fields(plan))
    ptr, sub = D.slice_index(tp)
    rel, sl = tp.rel_tile.reshape(-1), tp.slice_of.reshape(-1)
    live = np.flatnonzero((rel >= 0) & (sl >= 0))
    assert ptr.dtype == sub.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == len(live) == len(sub)
    assert sorted(sub) == list(live)
    for s in range(tp.n_slices):
        seg = sub[ptr[s]:ptr[s + 1]]
        assert (sl[seg] == s).all() and (np.diff(seg) > 0).all()


def _edge(v64, cols, n=4):
    v64 = np.asarray(v64, np.float64)
    rr = np.zeros(len(v64), np.int64)
    cc = np.asarray(cols, np.int64)
    port = D.SellDf64SpMV.from_coo_f64(rr, cc, v64, (n, n), chunk=8,
                                       device="cpu")
    jax_ = JDf64.from_coo_f64(rr, cc, v64, (n, n), chunk=8)
    x = np.ones(n)
    return (df_to_f64(*port(*df_split(x, device="cpu")))[0],
            j_to_f64(*jax_(*j_split(x)))[0])


def test_edge_scales_exact_in_the_port():
    """``test_df64_edge_scales_no_nan``'s cases: exact in the port, but
    for the low words of 1e-35 and 2e-35, which are float32 subnormals
    (spacing 2^-149); the JAX kernel held to its own bounds."""
    assert _edge([0.0], [0]) == (0.0, 0.0)
    t, j = _edge([1e-35, 2e-35], [0, 1])
    assert abs(t - 3e-35) <= 3 * 2.0 ** -149
    assert abs(j - 3e-35) < 1e-37
    t, j = _edge([1e30, -1e30, 3.0], [0, 1, 2])
    assert t == 3.0
    assert np.isfinite(j) and abs(j - 3.0) < 1e30 * 2.0 ** -45
    t, j = _edge([1e30, 1e-30, -1e30, 3.0], [0, 1, 2, 3])
    assert t == 3.0 and np.isfinite(j)


def test_refuses_streamed_plans_and_wide_windows():
    from smvp_toolkit_tpu.ops.sell_plan import build_streamed_sell_plan

    rng = np.random.RandomState(6)
    r = rng.randint(0, 4096, 3000).astype(np.int64)
    c = rng.randint(0, 4096, 3000).astype(np.int64)
    streamed = build_streamed_sell_plan(r, c, np.ones(3000, np.float32),
                                        (4096, 4096), chunk=64,
                                        y_block_rows=2048)
    rw, cw = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
    wide = jplan.build_sell_plan(rw, cw, rng.randn(800), (3000, 70000),
                                 chunk=1024)
    assert wide.window_tiles > 511
    for plan in (streamed, wide):
        with pytest.raises(ValueError):
            JDf64(plan)
        with pytest.raises(ValueError):
            D.SellDf64SpMV(plan_from_arrays(plan_fields(plan)), device="cpu")


def test_traffic_bytes_counts_each_plane_once(case):
    _, _, _, top = case
    p = top.plan
    lb = 1 if p.chunk % 32 == 0 else 4
    planes = (8 if top.vals_lo is not None else 4) + lb
    want = (p.n_sublanes * 128 * planes + p.n_sublanes * 4 + p.n_chunks * 4
            + (top.sublanes.numel() + p.n_slices + 1) * 4
            + 2 * p.n_coltiles * 128 * 4 + 2 * p.n_slices * 128 * 4)
    assert top.traffic_bytes() == want
