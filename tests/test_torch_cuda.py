"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on the same planes, and the
CLI's main path through the kernels' launch counters. This file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest builds the JAX package's native
libraries and imports JAX.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch.bench.bench_variants import spmm_tolerance
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    build_sell_plan,
    build_streamed_sell_plan,
)
from smvp_toolkit_tpu_torch.utils import fuzz

import test_torch_streamy_contract as streamy_plans
import torch_kcol_plans as kcol_plans

pytestmark = pytest.mark.cuda

TOL = 1e-6  # atomics change the summation order: never bitwise


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plan(chunk):
    rng = np.random.RandomState(chunk)
    n, m, nnz = 9000, 14000, 120000
    r = rng.randint(0, n // 2, size=nnz) * 2  # odd rows empty
    c = rng.randint(0, m, size=nnz)
    return build_sell_plan(r, c, rng.randn(nnz), (n, m), chunk=chunk,
                           allow_small_chunk=False)


def _rel(a, b):
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale else (
        (a - b).abs().max().item())


@pytest.mark.parametrize("chunk", [2048, 200])  # int8 / int32 lane indices
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(card, chunk, dtype):
    plan = _plan(chunk)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    xt = op._x_tiles(x)
    args = (op.vals, op.lidx, op.relsl, op.tile_base, xt)
    kw = dict(n_slices=plan.n_slices, chunk=plan.chunk)
    before = (S.sell_spmv.launches, S.sell_bench_loop.launches)
    y1 = S.sell_spmv(*args, **kw)
    y2 = S.sell_bench_loop(*args, iterations=3, **kw)
    yp = S.sell_spmv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (S.sell_spmv.launches, S.sell_bench_loop.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(y1, yp) <= TOL
    assert _rel(y2, yp) <= TOL


def test_empty_matrix(card):
    plan = build_sell_plan(np.zeros(0), np.zeros(0), np.zeros(0), (300, 200))
    op = S.SellSpMV(plan, device=card)
    x = torch.ones(200, device=card)
    assert not op(x).any() and not op.bench_loop(x, 2).any()


def test_cli_main_path_launches_kernels(card, tmp_path):
    from smvp_toolkit_tpu_torch.cli import main

    S.sell_spmv.launches = S.sell_bench_loop.launches = 0
    assert main(["-c", "-n", "5", "--no-report", "synth:20000:200000"]) == 0
    assert S.sell_spmv.launches >= 5 and S.sell_bench_loop.launches == 0
    S.sell_spmv.launches = 0
    assert main(["-c", "-n", "5", "--fused", "--no-report",
                 "synth:20000:200000"]) == 0
    assert S.sell_bench_loop.launches >= 1 and S.sell_spmv.launches == 0


def _route_plan(route):
    """A small plan on each route (2048-row y blocks when streamed)."""
    rng = np.random.RandomState(len(route))
    if route == "relsl":
        return _plan(2048)
    if route == "streamy_relsl":
        r = rng.randint(0, 9000, 60000)
        c = np.clip(r + rng.randint(-64, 65, 60000), 0, 8999)
        return build_streamed_sell_plan(r, c, rng.randn(60000), (9000, 9000),
                                        chunk=256, y_block_rows=2048)
    if route == "streamy":  # WT > 511 in every block
        r, c = rng.randint(0, 4200, 1500), rng.randint(0, 70000, 1500)
        return build_streamed_sell_plan(r, c, rng.randn(1500), (4200, 70000),
                                        chunk=1024, y_block_rows=2048)
    # split: one chunk over 547 column tiles, WT > 511
    r, c = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
    return build_sell_plan(r, c, rng.randn(800), (3000, 70000), chunk=1024)


@pytest.mark.parametrize("route", S.ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_kernels_match_plain(card, route, dtype):
    plan = _route_plan(route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    assert op.route == route
    fwd, bench = S._ROUTE_FNS[route]
    plain = getattr(S, fwd.__name__ + "_plain")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    xt = op._x_tiles(x)
    before = (fwd.launches, bench.launches)
    y1 = fwd(*op._planes(), xt, **op._kw())
    y2 = bench(*op._planes(), xt, iterations=3, **op._kw())
    yp = plain(*op._planes(), xt, **op._kw())
    torch.cuda.synchronize()
    assert (fwd.launches, bench.launches) == (before[0] + 1, before[1] + 1)
    assert _rel(y1, yp) <= TOL
    assert _rel(y2, yp) <= TOL


def test_streamed_empty_middle_block_zero(card):
    r = np.array([5, 17, 2 * 2048 + 9])
    plan = build_streamed_sell_plan(r, np.array([3, 499, 123]),
                                    np.array([1.5, -2.0, 4.25]), (6144, 500),
                                    chunk=256, y_block_rows=2048)
    op = S.SellSpMV(plan, device=card)
    x = torch.arange(1.0, 501.0, device=card)
    for y in (op(x), op.bench_loop(x, 2)):
        assert not y[2048:4096].any()
        assert y[5].item() == 1.5 * 4 and y[17].item() == -2.0 * 500


def _split_fns(route):
    """The forward and N-iteration wrappers of a route, and the forward's
    plain version."""
    fwd, bench = S._ROUTE_FNS[route]
    return fwd, bench, getattr(S, fwd.__name__ + "_plain")


@pytest.mark.parametrize("route", streamy_plans.ROUTES)
@pytest.mark.parametrize("name", streamy_plans.NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamy_kernels_contract(card, name, dtype, route):
    """The kernels of every route on the contract plans against their
    plain versions: the warp-per-sublane forward kernels (K3-split, K4,
    and on the merged word K3-relsl and K1) and N-iteration kernels (K2
    streamed split, K2 split, K2 streamed and K2); N = 3 against one
    launch; Inf at a padding lane's column: NaN in the same rows as the
    plain version, and only there."""
    plan = streamy_plans.contract_plan(name, route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    fwd, bench, plain = _split_fns(route)
    planes, kw = op._planes(route), op._kw()
    x = np.random.default_rng(4).standard_normal(plan.shape[1])
    xt = op._x_tiles(torch.from_numpy(x.astype(np.float32)).to(card))
    before = (fwd.launches, bench.launches)
    y1 = fwd(*planes, xt, **kw)
    yb1 = bench(*planes, xt, iterations=1, **kw)
    y3 = bench(*planes, xt, iterations=3, **kw)
    yp = plain(*planes, xt, **kw)
    torch.cuda.synchronize()
    assert (fwd.launches, bench.launches) == (before[0] + 1, before[1] + 2)
    for y in (y1, yb1, y3):
        assert _rel(y, yp) <= TOL
    assert _rel(y3, y1) <= TOL
    col, rows = streamy_plans.padding_column(plan)
    xt[col] = float("inf")
    want = torch.isnan(plain(*planes, xt, **kw))
    assert want.nonzero().squeeze(1).cpu().numpy().tolist() == rows.tolist()
    for y in (fwd(*planes, xt, **kw), bench(*planes, xt, iterations=3, **kw)):
        assert torch.equal(torch.isnan(y), want)
        assert torch.isfinite(y[~want]).all()


@pytest.mark.parametrize("route", streamy_plans.ROUTES)
@pytest.mark.parametrize("plane", ["vals", "lidx"])
def test_streamy_misaligned_plane_raises(card, plane, route):
    """A plane view at an odd offset: the launches of the forward and the
    N-iteration kernel (both on the warp-per-sublane body, whose vector
    loads need four-element alignment) are refused, never run on another
    body or the plain version, and count no launch."""
    plan = streamy_plans.contract_plan("dead-run-ends-chunk", route)
    op = S.SellSpMV(plan, device=card)
    fwd, bench, _ = _split_fns(route)
    planes, kw = list(op._planes(route)), op._kw()
    i = 0 if plane == "vals" else 1
    t = planes[i]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    planes[i] = flat[1:].view(t.shape)
    planes[i].copy_(t)
    xt = op._x_tiles(torch.ones(plan.shape[1], device=card))
    before = (fwd.launches, bench.launches)
    with pytest.raises(RuntimeError, match="misaligned"):
        fwd(*planes, xt, **kw)
    assert fwd.launches == before[0]
    with pytest.raises(RuntimeError, match="misaligned"):
        bench(*planes, xt, iterations=2, **kw)
    assert (fwd.launches, bench.launches) == before


@pytest.mark.parametrize("route", streamy_plans.ROUTES)
def test_split_no_live_sublane_zero(card, route):
    """A plan with no live sublane: both kernels launch and return y = 0,
    as their plain versions do."""
    op, planes, kw = streamy_plans.no_live_planes(route)
    planes = [t.to(card) for t in planes]
    fwd, bench, _ = _split_fns(route)
    xt = torch.ones(op.plan.n_coltiles * 128, device=card)
    before = (fwd.launches, bench.launches)
    for y in (fwd(*planes, xt, **kw), bench(*planes, xt, iterations=2, **kw)):
        assert y.shape == (op.plan.n_slices * 128,) and not y.any()
    assert (fwd.launches, bench.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("route", streamy_plans.ROUTES)
def test_split_planes_of_no_sublane(card, route):
    """Planes of no sublane at all: the launches of both warp-per-sublane
    kernels, forward and N-iteration, are refused (no work item), with no
    launch counted."""
    plan = streamy_plans.contract_plan("dead-run-ends-chunk", route)
    op = S.SellSpMV(plan, device=card)
    fwd, bench, _ = _split_fns(route)
    planes = [t[:0] for t in op._planes(route)]
    xt = op._x_tiles(torch.ones(plan.shape[1], device=card))
    before = (fwd.launches, bench.launches)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fwd(*planes, xt, **op._kw())
    assert fwd.launches == before[0]
    with pytest.raises(RuntimeError, match="invalid argument"):
        bench(*planes, xt, iterations=2, **op._kw())
    assert (fwd.launches, bench.launches) == before


def test_split_launch_views_match_plain(card, monkeypatch):
    """SMVP_SELL_SPLIT=3 on the resident int32-lane plan (chunk 200): three
    K4 launches on views over chunk ranges, each aligned for the vector
    loads, summed to the plain version's y."""
    plan = streamy_plans.contract_plan("int32-lidx", "split")
    op = S.SellSpMV(plan, device=card)
    assert op.route == "split" and op.lidx.dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    yp = S.sell_split_plain(*op._planes(), op._x_tiles(x), **op._kw())
    monkeypatch.setenv("SMVP_SELL_SPLIT", "3")
    before = S.sell_split.launches
    y = op(x)
    torch.cuda.synchronize()
    assert S.sell_split.launches == before + plan.n_chunks == before + 3
    assert _rel(y, yp[: plan.shape[0]]) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [2048, 200])  # int8 / int32 lane indices
def test_k1_split_launch_views_match_plain(card, chunk, dtype, monkeypatch):
    """SMVP_SELL_SPLIT=4 on a resident merged-word plan: four K1 launches
    on views over chunk ranges (each aligned for the vector loads, the
    last range shorter), summed to the plain version's y."""
    plan = _plan(chunk)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    assert op.route == "relsl" and plan.n_chunks >= 4
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    yp = S.sell_spmv_plain(*op._planes(), op._x_tiles(x), **op._kw())
    monkeypatch.setenv("SMVP_SELL_SPLIT", "4")
    before = S.sell_spmv.launches
    y = op(x)
    torch.cuda.synchronize()
    assert S.sell_spmv.launches == before + 4
    assert _rel(y, yp[: plan.shape[0]]) <= TOL


@pytest.mark.parametrize("route", ["relsl", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_caller_vals_at_odd_offset_get_aligned_storage(card, route, dtype,
                                                       monkeypatch):
    """A ``vals`` plane that a caller passes as a view at an odd offset
    (``matmat(X, vals=...)`` with k = 1, and per column under
    ``SMVP_SELL_SPMM=0``, as the edge training path calls it) is copied
    into aligned storage before the forward kernel's launch: the kernel
    launches once per column and y equals the plain version's on the
    same values."""
    plan = (_plan(2048) if route == "relsl" else
            streamy_plans.contract_plan("dead-run-ends-chunk", "split"))
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    assert op.route == route
    fwd, _, plain = _split_fns(route)
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(
        op.vals.numel()).astype(np.float32)).to(card).to(dtype)
    v = v * (op.vals.reshape(-1) != 0)
    flat = torch.empty(v.numel() + 1, dtype=dtype, device=card)
    odd = flat[1:]
    odd.copy_(v)
    assert odd.data_ptr() % 16
    X = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (plan.shape[1], 2)).astype(np.float32)).to(card)
    planes = (v.reshape(op.vals.shape),) + op._planes(route)[1:]
    want = torch.stack([plain(*planes, op._x_tiles(X[:, j]), **op._kw())[
        : plan.shape[0]] for j in range(2)], dim=1)
    before = fwd.launches
    y1 = op.matmat(X[:, :1], vals=odd)
    monkeypatch.setenv("SMVP_SELL_SPMM", "0")
    y2 = op.matmat(X, vals=odd)
    torch.cuda.synchronize()
    assert fwd.launches == before + 3
    assert _rel(y1, want[:, :1]) <= TOL and _rel(y2, want) <= TOL


def test_cli_tjds_path_launches_kernels(card):
    from smvp_toolkit_tpu_torch.cli import main

    S.sell_spmv.launches = S.sell_bench_loop.launches = 0
    assert main(["-t", "--decode-check", "-n", "5", "--no-report",
                 "synth:20000:200000"]) == 0
    assert S.sell_spmv.launches >= 5 and S.sell_bench_loop.launches == 0


# -- the k-column kernels: K1/K4 with k > 1, K2 with k > 1, K7 -------------


def _block(card, rows, k, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, k)).astype(np.float32)).to(card).to(dtype).contiguous()


# k = 4, 8, 40, 256 and 300 take the vector column form (300: two column
# blocks), 1, 2, 6 and 17 the scalar one (spmv_sell.spmm_shape).
@pytest.mark.parametrize("k", [1, 2, 4, 6, 8, 17, 40, 256, 300])
@pytest.mark.parametrize("route", ["relsl", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kcolumn_kernels_match_plain(card, route, dtype, k):
    plan = _route_plan(route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    assert op.route == route
    kw = op._mat_kw()
    X = _block(card, plan.n_coltiles * 128, k, 3, dtype)
    G = _block(card, plan.n_slices * 128, k, 4)
    fwd = op.spmm_kernel
    plain = getattr(S, fwd.__name__ + "_plain")
    before = {n: f.launches for n, f in S.MAT_KERNELS.items()}
    y1 = fwd(*op._planes(), X, **kw)
    yp = plain(*op._planes(), X, **kw)
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    g1 = S.sell_vals_grad(op.lidx, op.tile_base, X, G, **meta, **kw)
    gp = S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta, **kw)
    want = {fwd.kernel: 1, "sell_vals_grad_kernel": 1}
    if route == "relsl":
        y2 = S.sell_bench_spmm(*op._planes(), X, iterations=3, **kw)
        want["sell_bench_spmm_kernel"] = 1
    torch.cuda.synchronize()
    after = {n: f.launches - before[n] for n, f in S.MAT_KERNELS.items()}
    assert after == {n: want.get(n, 0) for n in S.MAT_KERNELS}
    assert y1.shape == (plan.n_slices * 128, k) and g1.shape == op.vals.shape
    assert _rel(y1, yp) <= TOL
    assert _rel(g1, gp) <= TOL
    dead = (plan.rel_tile.reshape(-1) < 0) | (plan.slice_of.reshape(-1) < 0)
    assert not g1[torch.from_numpy(dead).to(card)].any()
    if route == "relsl":
        assert _rel(y2, yp) <= TOL


@pytest.mark.parametrize("k", [6, 8, 40, 256])
@pytest.mark.parametrize("route", ["relsl", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kcolumn_hub_row_matches_plain(card, route, dtype, k):
    """A row of 200 entries in one column tile: its 200 duplicate sublanes
    run past several 64-sublane work items, each piece summed per row and
    flushed once; K1 / K4 with k columns equal the plain version."""
    plan = kcol_plans.hub_row_plan(route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    assert op.route == route
    X = _block(card, plan.n_coltiles * 128, k, 6, dtype)
    fwd = op.spmm_kernel
    plain = getattr(S, fwd.__name__ + "_plain")
    before = fwd.launches
    y = fwd(*op._planes(), X, **op._mat_kw())
    yp = plain(*op._planes(), X, **op._mat_kw())
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    row = kcol_plans.HUB_ROW
    tol, _ = spmm_tolerance(plan)  # the run's sums in another order
    assert yp[row].abs().max() > 0
    assert _rel(y, yp) <= tol
    assert _rel(y[row], yp[row]) <= tol


@pytest.mark.parametrize("k", [1, 2, 6, 8, 40, 256])
@pytest.mark.parametrize("route", ["relsl", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vals_grad_hub_row_matches_plain(card, route, dtype, k):
    """K7 on the hub-row plan: the hub slice's 200 live sublanes are cut
    into units of ``VG_CAP`` that several blocks take; the plane equals
    the plain version, its padding lanes carry partials and its dead
    sublanes are 0."""
    plan = kcol_plans.hub_row_plan(route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    sched = op.vals_grad_schedule()
    assert (sched.unit_slice == kcol_plans.HUB_ROW // 128).sum() > 1
    X = _block(card, plan.n_coltiles * 128, k, 7, dtype)
    G = _block(card, plan.n_slices * 128, k, 8)
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    before = S.sell_vals_grad.launches
    g = S.sell_vals_grad(op.lidx, op.tile_base, X, G, schedule=sched, **meta,
                         **op._mat_kw())
    gp = S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta,
                                **op._mat_kw())
    torch.cuda.synchronize()
    assert S.sell_vals_grad.launches == before + 1
    assert _rel(g, gp) <= TOL
    dead = (plan.rel_tile.reshape(-1) < 0) | (plan.slice_of.reshape(-1) < 0)
    live = torch.from_numpy(~dead).to(card)
    assert not g[~live].any()
    nz = torch.from_numpy(plan.vals != 0).to(card)
    assert (g[live] != 0).sum() > nz[live].sum()  # padding lanes' partials


@pytest.mark.parametrize("k", [1, 8, 256])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_vals_grad_writes_every_word(card, route, k):
    """The wrapper allocates the plane with torch.empty: launched into a
    block the caching allocator has just freed full of NaN, every word
    comes out written (dead sublanes exactly 0)."""
    plan = _route_plan(route)
    op = S.SellSpMV(plan, device=card)
    X = _block(card, plan.n_coltiles * 128, k, 11)
    G = _block(card, plan.n_slices * 128, k, 12)
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    sched = op.vals_grad_schedule()
    torch.cuda.synchronize()
    poison = torch.full(op.lidx.shape, float("nan"), device=card)
    ptr = poison.data_ptr()
    del poison
    g = S.sell_vals_grad(op.lidx, op.tile_base, X, G, schedule=sched, **meta,
                         **op._mat_kw())
    torch.cuda.synchronize()
    assert g.data_ptr() == ptr  # the NaN block itself
    assert torch.isfinite(g).all()
    dead = (plan.rel_tile.reshape(-1) < 0) | (plan.slice_of.reshape(-1) < 0)
    assert dead.any() and not g[torch.from_numpy(dead).to(card)].any()
    gp = S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta,
                                **op._mat_kw())
    assert _rel(g, gp) <= TOL


@pytest.mark.parametrize("what", ["lidx", "X", "G", "empty", "chunks"])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_vals_grad_refusals(card, route, what):
    """K7 refuses a lane-index plane, X or G one element off the alignment
    its vector loads need (k = 8: "misaligned address"), planes of no
    sublane ("invalid argument") and planes that are not whole chunks (the
    wrapper's check), counting no launch."""
    plan = _route_plan(route)
    op = S.SellSpMV(plan, device=card)
    kw = op._mat_kw()
    X = _block(card, plan.n_coltiles * 128, 8, 13)
    G = _block(card, plan.n_slices * 128, 8, 14)
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    lidx, tile_base = op.lidx, op.tile_base

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    error, match = RuntimeError, "misaligned"
    if what == "lidx":
        lidx = shifted(lidx)
    elif what == "X":
        X = shifted(X)
    elif what == "G":
        G = shifted(G)
    elif what == "empty":
        lidx, tile_base = lidx[:0], tile_base[:0]
        meta = {k: None if t is None else t[:0] for k, t in meta.items()}
        match = "invalid argument"
    else:
        lidx = lidx[:-1]
        meta = {k: None if t is None else t[:-1] for k, t in meta.items()}
        error, match = ValueError, "chunks"
    before = S.sell_vals_grad.launches
    with pytest.raises(error, match=match):
        S.sell_vals_grad(lidx, tile_base, X, G, **meta, **kw)
    assert S.sell_vals_grad.launches == before


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_kcolumn_zero_value_skips_inf(card, route, k):
    """A zero-valued slot contributes nothing: X holds Inf in the column
    of a padding lane, whose real entries are zeroed through the values
    plane, so only zero-valued slots read it; Y stays finite and equals
    the plain version (vector form at k = 8, scalar at k = 6)."""
    plan = _route_plan(route)
    op = S.SellSpMV(plan, device=card)
    vals = plan.vals.reshape(-1, 128)
    live = (plan.rel_tile.reshape(-1) >= 0) & (plan.slice_of.reshape(-1) >= 0)
    s = np.arange(vals.shape[0])
    cols = ((plan.tile_base.astype(np.int64)[s // plan.chunk]
             + plan.rel_tile.reshape(-1))[:, None] * 128
            + plan.lane_idx.reshape(vals.shape))
    pad = live[:, None] & (vals == 0)
    col = int(cols[pad][0])
    v = op.vals.clone().reshape(vals.shape)
    v[torch.from_numpy(live[:, None] & (cols == col)).to(card)] = 0
    planes = (v.reshape(op.vals.shape),) + tuple(op._planes()[1:])
    X = _block(card, plan.n_coltiles * 128, k, 9)
    X[col] = float("inf")
    fwd = op.spmm_kernel
    plain = getattr(S, fwd.__name__ + "_plain")
    y = fwd(*planes, X, **op._mat_kw())
    yp = plain(*planes, X, **op._mat_kw())
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(yp).all()
    assert _rel(y, yp) <= TOL


@pytest.mark.parametrize("what", ["X", "vals"])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_kcolumn_misaligned_view_raises(card, route, what):
    """An X view one element off its 16-byte alignment at k = 8 (the
    vector form's float4 gathers), or a values plane one element off
    (step 1's vector loads): the launch is refused with "misaligned
    address" and counts none. At k = 6 (the scalar form) the same X view
    launches and equals the plain version."""
    plan = _route_plan(route)
    op = S.SellSpMV(plan, device=card)
    fwd = op.spmm_kernel
    plain = getattr(S, fwd.__name__ + "_plain")
    planes, kw = list(op._planes()), op._mat_kw()

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    for k in (8, 6):
        X = _block(card, plan.n_coltiles * 128, k, 10)
        args = list(planes)
        if what == "X":
            X = shifted(X)
        else:
            args[0] = shifted(args[0])
        before = fwd.launches
        if what == "X" and k == 6:
            y = fwd(*args, X, **kw)
            torch.cuda.synchronize()
            assert fwd.launches == before + 1
            assert _rel(y, plain(*args, X, **kw)) <= TOL
            continue
        with pytest.raises(RuntimeError, match="misaligned"):
            fwd(*args, X, **kw)
        assert fwd.launches == before


# -- K2 with k columns: the k-column body N times in one cooperative launch

@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 8, 17])
@pytest.mark.parametrize("plan_name", ["small", "hub-row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kcol_bench_matches_plain_and_k1(card, dtype, plan_name, k,
                                         iterations):
    """K2 with k columns takes two Y buffers in turn (N = 1 and 3 end in
    buffer 0, N = 2 in buffer 1): on the small resident plan and the
    hub-row plan (200 duplicate sublanes of one row past several work
    items), each N equals the plain version and one K1-with-k launch within
    the plan's SpMM tolerance (scalar columns at k = 2 and 17, vector at
    8)."""
    plan = (_route_plan("relsl") if plan_name == "small"
            else kcol_plans.hub_row_plan("relsl"))
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    kw = op._mat_kw()
    X = _block(card, plan.n_coltiles * 128, k, 20 + k, dtype)
    before = S.sell_bench_spmm.launches
    y = S.sell_bench_spmm(*op._planes(), X, iterations=iterations, **kw)
    yp = S.sell_bench_spmm_plain(*op._planes(), X, iterations=iterations,
                                 **kw)
    y1 = S.sell_spmm(*op._planes(), X, **kw)
    torch.cuda.synchronize()
    assert S.sell_bench_spmm.launches == before + 1
    assert S.MAT_BENCH_Y_BUFFERS == 2
    tol, _ = spmm_tolerance(plan)
    assert y.shape == yp.shape == (plan.n_slices * 128, k)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, yp) <= tol and _rel(y, y1) <= tol


@pytest.mark.parametrize("k", [2, 6, 8, 17, 40, 256])
def test_kcol_bench_grid_is_coresident(card, k):
    """K2 with k columns' cooperative grid for each column shape: at least
    kMatMinBlocks (4) co-resident blocks on every SM."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        blocks = S.bench_spmm_blocks(dtype, torch.int8, card, k=k)
        assert blocks >= 4 * sms and blocks % sms == 0


@pytest.mark.parametrize("k", [6, 8])
def test_kcol_bench_zero_value_skips_inf(card, k):
    """K2 with k columns keeps the zero-value contract: X holds Inf in the
    column of a padding lane whose real entries are zeroed through the
    values plane; after N = 3 Y stays finite and equals the plain
    version."""
    plan = _route_plan("relsl")
    op = S.SellSpMV(plan, device=card)
    vals = plan.vals.reshape(-1, 128)
    live = (plan.rel_tile.reshape(-1) >= 0) & (plan.slice_of.reshape(-1) >= 0)
    s = np.arange(vals.shape[0])
    cols = ((plan.tile_base.astype(np.int64)[s // plan.chunk]
             + plan.rel_tile.reshape(-1))[:, None] * 128
            + plan.lane_idx.reshape(vals.shape))
    col = int(cols[live[:, None] & (vals == 0)][0])
    v = op.vals.clone().reshape(vals.shape)
    v[torch.from_numpy(live[:, None] & (cols == col)).to(card)] = 0
    planes = (v.reshape(op.vals.shape),) + tuple(op._planes()[1:])
    X = _block(card, plan.n_coltiles * 128, k, 9)
    X[col] = float("inf")
    y = S.sell_bench_spmm(*planes, X, iterations=3, **op._mat_kw())
    yp = S.sell_bench_spmm_plain(*planes, X, iterations=3, **op._mat_kw())
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(yp).all()
    assert _rel(y, yp) <= TOL


@pytest.mark.parametrize("what", ["X", "vals"])
def test_kcol_bench_misaligned_view_raises(card, what):
    """K2 with k columns takes K1-with-k's alignment rule: an X view one
    element off at k = 8, or a values plane one element off, is refused
    with "misaligned address" and counts no launch; at k = 6 the same X
    view launches and equals the plain version."""
    plan = _route_plan("relsl")
    op = S.SellSpMV(plan, device=card)
    planes, kw = list(op._planes()), op._mat_kw()

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    fn = S.sell_bench_spmm
    for k in (8, 6):
        X = _block(card, plan.n_coltiles * 128, k, 10)
        args = list(planes)
        if what == "X":
            X = shifted(X)
        else:
            args[0] = shifted(args[0])
        before = fn.launches
        if what == "X" and k == 6:
            y = fn(*args, X, iterations=2, **kw)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert _rel(y, S.sell_bench_spmm_plain(
                *args, X, iterations=2, **kw)) <= TOL
            continue
        with pytest.raises(RuntimeError, match="misaligned"):
            fn(*args, X, iterations=2, **kw)
        assert fn.launches == before


def test_matmat_and_autograd_on_card(card):
    rng = np.random.RandomState(5)
    n, m, nnz, k = 3000, 2500, 20000, 6
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    key = np.unique(r.astype(np.int64) * m + c)
    r, c = key // m, key % m
    v = rng.randn(len(r)).astype(np.float32)
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    coo = COOMatrix.from_numpy(r, c, v, shape=(n, m), device=card)
    op = S.SellSpMV.from_coo(coo)
    dense = np.zeros((n, m))
    dense[r, c] = v
    X = _block(card, m, k, 1).requires_grad_(True)
    W = _block(card, n, k, 2)
    vv = torch.from_numpy(v).to(card).requires_grad_(True)
    before = {n_: f.launches for n_, f in S.MAT_KERNELS.items()}
    out = op.differentiable_edges_mat()(vv, X)
    (W * out).sum().backward()
    torch.cuda.synchronize()
    Xn, Wn = X.detach().double().cpu().numpy(), W.double().cpu().numpy()
    np.testing.assert_allclose(out.detach().cpu().numpy(), dense @ Xn,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vv.grad.cpu().numpy(),
                               (Wn[r] * Xn[c]).sum(axis=1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(X.grad.cpu().numpy(), dense.T @ Wn,
                               rtol=1e-4, atol=1e-5)
    after = {n_: f.launches - before[n_] for n_, f in S.MAT_KERNELS.items()}
    assert after["sell_vals_grad_kernel"] == 1
    assert after[op.spmm_kernel.kernel] + after[
        op.transpose().spmm_kernel.kernel] >= 2


def test_gcn_step_on_card_matches_spmm_csr(card):
    from smvp_toolkit_tpu_torch.models import gcn_init, gcn_norm
    from smvp_toolkit_tpu_torch.models import gcn_train_step
    from smvp_toolkit_tpu_torch.ops.spmv_torch import spmm_csr
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    s = gcn_norm(synth_powerlaw(5000, 40000, seed=1, device=card))
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((5000, 16)).astype(
        np.float32)).to(card)
    labels = torch.from_numpy(rng.integers(0, 5, 5000)).to(card)
    mask = torch.arange(5000, device=card) < 3000
    models = [gcn_init(torch.Generator().manual_seed(0), [16, 32, 5],
                       device=card) for _ in range(2)]
    S.sell_spmm.launches = S.sell_split_spmm.launches = 0
    _, loss = gcn_train_step(s, models[0], h, labels, mask)
    assert S.sell_spmm.launches + S.sell_split_spmm.launches >= 4
    _, loss_ref = gcn_train_step(s, models[1], h, labels, mask,
                                 spmm=spmm_csr)
    assert abs(loss.item() - loss_ref.item()) <= 1e-4 * abs(loss_ref.item())
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-5)


def test_bench_spmm_grid_is_coresident(card):
    blocks = S.bench_spmm_blocks(torch.float32, torch.int8, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert blocks >= sms and blocks % sms == 0


@pytest.mark.parametrize("route", S.ROUTES)
@pytest.mark.parametrize("lidx", [torch.int8, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bench_grid_is_coresident(card, route, dtype, lidx):
    """Every route's N-iteration kernel runs the warp-per-sublane body
    under its launch bound: eight co-resident blocks on each SM."""
    blocks = S.bench_blocks(dtype, lidx, card, route=route)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert blocks == 8 * sms


@pytest.mark.parametrize("route", S.ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bench_two_buffers_match_plain(card, route, dtype):
    """K2 takes two y buffers in turn (odd N end in the first, even N in
    the second), the other N-iteration kernels one: on every route N = 1,
    2, 3 and 4 each return y equal to one plain SpMV."""
    plan = _route_plan(route)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    _, bench, plain = _split_fns(route)
    planes, kw = op._planes(route), op._kw()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    xt = op._x_tiles(x)
    yp = plain(*planes, xt, **kw)
    for n in (1, 2, 3, 4):
        y = bench(*planes, xt, iterations=n, **kw)
        torch.cuda.synchronize()
        assert y.shape == yp.shape and y.is_contiguous()
        assert _rel(y, yp) <= TOL, n


def test_cli_spmm_launches_kcolumn_kernels(card, tmp_path):
    from smvp_toolkit_tpu_torch.cli import main

    spec = "synth:20000:200000"
    for fused, want in ((False, "sell_spmm_kernel"),
                        (True, "sell_bench_spmm_kernel")):
        for fn in S.MAT_KERNELS.values():
            fn.launches = 0
        argv = ["-c", "-n", "3", "--no-report", "--spmm", "4",
                "--out-dir", str(tmp_path)] + (["--fused"] if fused else [])
        assert main(argv + [spec]) == 0
        counts = {n: f.launches for n, f in S.MAT_KERNELS.items()}
        assert counts.pop(want) >= 3 and not any(counts.values())
        assert np.load(tmp_path / "spmm.npy").shape == (20000, 4)


# -- the fused solvers: K9 (CG), K10 (Chebyshev), K11 (IC(0)-PCG) ----------

SOLVER_TOL = 1e-4  # reductions re-associate; the JAX fused-solver tolerance
# bfloat16 after 30 steps: two units of bf16 rounding. A one-ulp float32
# difference between two summation orders now and then flips the bf16
# rounding of an SpMV input entry (a jump of 2^-9), which CG's scalars carry
# into every later step: kernel and plain agree within 1e-4 for the first
# steps and drift to about 2e-3 by step 30, while each alone repeats itself
# within 1e-6 (measured on the H100). The 3-step check at SOLVER_TOL is the
# one that catches a kernel skipping the bf16 rounding; the 30-step limit
# only bounds the drift.
SOLVER_TOL_BF16 = 2.0 ** -7


def _stencil_csr(kind, card):
    """A CSR on the card: 2-D Poisson 64² or 256², or the HPCG 27-point
    stencil on 16³ (diagonal 26, neighbours −1)."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

    a = (poisson2d(int(kind[len("poisson"):])) if kind.startswith("poisson")
         else hpcg_stencil(16)).tocoo()
    coo = COOMatrix.from_numpy(a.row, a.col, a.data, shape=a.shape,
                               pad_to=128, device=card)
    return csr_encode(coo)


def _solver_rel(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


@pytest.mark.parametrize("kind", ["poisson64", "hpcg16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_solvers_match_plain(card, kind, dtype):
    import dataclasses

    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.ops.ilu import ic0

    csr = _stencil_csr(kind, card)
    if dtype == torch.bfloat16:
        csr = dataclasses.replace(csr, vals=csr.vals.to(dtype))
    op = S.sell_op_csr(csr)
    n = csr.shape[0]
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(
        np.float32)).to(card)
    factors = ic0(csr)
    steps = (3, 30) if dtype == torch.bfloat16 else (30,)
    before = {k: f.launches for k, f in P.SOLVER_KERNELS.items()}
    runs = []
    for it in steps:
        runs += [(f"cg {it}", C.fused_cg(op, b, it),
                  C.fused_cg_plain(op, b, it)),
                 (f"cheb {it}", P.fused_chebyshev(op, b, 0.05, 30.0, it),
                  P.fused_chebyshev_plain(op, b, 0.05, 30.0, it))]
        for sweeps in (2, 4):
            runs.append((f"ic0 s{sweeps} {it}",
                         P.fused_pcg_ic0(op, factors, b, it, sweeps=sweeps),
                         P.fused_pcg_ic0_plain(op, factors, b, it,
                                               sweeps=sweeps)))
    torch.cuda.synchronize()
    after = {k: f.launches - before[k] for k, f in P.SOLVER_KERNELS.items()}
    k = len(steps)
    assert after == {"sell_cg_kernel": k, "sell_chebyshev_kernel": k,
                     "sell_pcg_ic0_kernel": 2 * k}
    for name, got, want in runs:
        assert got.shape == (n,) and bool(torch.isfinite(got).all()), name
        tol = SOLVER_TOL_BF16 if name.endswith(" 30") and (
            dtype == torch.bfloat16) else SOLVER_TOL
        assert _solver_rel(got, want) <= tol, (name, _solver_rel(got, want))


def test_fused_cg_split_planes_matches_plain(card):
    from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg, fused_cg_plain
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan

    # 256² is the smallest Poisson grid with 512 column tiles, so that a
    # widened window can pass 511 (a window never exceeds CT).
    csr = _stencil_csr("poisson256", card)
    op = S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, 512), device=card)
    assert op.route == "split"
    b = torch.ones(csr.shape[0], device=card)
    got, want = fused_cg(op, b, 30), fused_cg_plain(op, b, 30)
    assert _solver_rel(got, want) <= SOLVER_TOL


def test_fused_solvers_zero_iterations_and_refusals(card):
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg
    from smvp_toolkit_tpu_torch.ops.ilu import ic0
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan

    csr = _stencil_csr("poisson64", card)
    op = S.sell_op_csr(csr)
    b = torch.ones(csr.shape[0], device=card)
    before = {k: f.launches for k, f in P.SOLVER_KERNELS.items()}
    for x in (fused_cg(op, b, 0), P.fused_chebyshev(op, b, 0.1, 8.0, 0),
              P.fused_pcg_ic0(op, ic0(csr), b, 0)):
        assert x.shape == b.shape and not x.any()
    assert before == {k: f.launches for k, f in P.SOLVER_KERNELS.items()}
    csr = _stencil_csr("poisson256", card)
    b = torch.ones(csr.shape[0], device=card)
    split = S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, 512),
                       device=card)
    assert split.route == "split"
    with pytest.raises(ValueError, match="relsl"):
        P.fused_chebyshev(split, b, 0.1, 8.0, 3)
    with pytest.raises(ValueError, match="relsl"):
        P.fused_pcg_ic0(split, ic0(csr), b, 3)
    streamed = S.SellSpMV(build_streamed_sell_plan(
        np.arange(6000), np.arange(6000), np.ones(6000), (6000, 6000),
        chunk=256, y_block_rows=2048), device=card)
    with pytest.raises(ValueError, match="resident-y"):
        fused_cg(streamed, torch.ones(6000, device=card), 3)


@pytest.mark.parametrize("what", ["q", "chunks"])
def test_chebyshev_refusals(card, what):
    """K10's warp-per-sublane SpMV phase refuses a q one word off 16 bytes
    ("misaligned address") and planes that are not whole chunks ("invalid
    argument"): nothing launches, no launch is counted, the state is left
    as it was."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P

    op = S.sell_op_csr(_stencil_csr("poisson64", card))
    n = C.state_tiles(op.plan) * 128
    b = torch.ones(n, device=card)
    x, r, d = (torch.zeros(n, device=card) for _ in range(3))
    qbuf = torch.zeros(n + 1, device=card)
    q = qbuf[1:] if what == "q" else qbuf[:n]
    coef = torch.ones(2 * 3, device=card)
    before = P.fused_chebyshev.launches
    if what == "q":
        with pytest.raises(RuntimeError, match="misaligned"):
            C.launch("sell_chebyshev_kernel", op, route="relsl",
                     planes=dict(vals=op.vals, lidx=op.lidx, relsl=op.relsl,
                                 tile_base=op.tile_base),
                     b=b, x=x, r=r, p=d, q=q, xin=d, iterations=3,
                     coef=coef, inv_theta=0.1)
    else:  # a whole chunk's slots less one sublane: ctypes, past the checks
        lib = C._lib()
        part = torch.zeros(2, dtype=torch.float64, device=card)
        rc = lib.sell_solver_launch(
            1, 0, op.vals.data_ptr(), op.lidx.data_ptr(),
            op.relsl.data_ptr(), None, op.tile_base.data_ptr(),
            b.data_ptr(), coef.data_ptr(), None, x.data_ptr(), r.data_ptr(),
            d.data_ptr(), q.data_ptr(), None, d.data_ptr(), part.data_ptr(),
            1, op.vals.numel() - 128, op.vals.numel() - 128,
            op.vals.numel() - 128, n, op.plan.chunk, 3, 0, 0.1, 0,
            int(op.lidx.dtype == torch.int32), card.index or 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0 and "invalid argument" in lib.sell_error_string(
            rc).decode()
    torch.cuda.synchronize()
    assert P.fused_chebyshev.launches == before
    assert not (x.any() or r.any() or d.any() or qbuf.any())


@pytest.mark.parametrize("what", ["q", "bounds"])
def test_pcg_ic0_refusals(card, what):
    """K11's warp-per-sublane SpMV phases refuse a q one word off 16 bytes
    ("misaligned address") and a strict(L) bound one sublane past a chunk
    boundary ("invalid argument"): nothing launches, no launch is counted,
    the state is left as it was."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.ops.ilu import ic0

    csr = _stencil_csr("poisson64", card)
    op = S.sell_op_csr(csr)
    fp = P._ic0_planes(op, ic0(csr))
    n = len(fp.invd)
    b = torch.ones(n, device=card)
    x, r, p, z = (torch.zeros(n, device=card) for _ in range(4))
    xin = torch.zeros(n, device=card)
    qbuf = torch.zeros(n + 1, device=card)
    q = qbuf[1:] if what == "q" else qbuf[:n]
    s_a, s_l = fp.sublane_bounds[1] * 128, fp.sublane_bounds[2] * 128
    if what == "bounds":
        s_l += 128
    before = P.fused_pcg_ic0.launches
    with pytest.raises(RuntimeError, match=("misaligned" if what == "q"
                                            else "invalid argument")):
        C.launch("sell_pcg_ic0_kernel", op, route="relsl",
                 planes=dict(vals=fp.vals, lidx=fp.lidx, relsl=fp.relsl,
                             tile_base=fp.tile_base),
                 b=b, x=x, r=r, p=p, q=q, xin=xin, iterations=3,
                 invd=fp.invd, z=z, slots_l0=s_a, slots_lt0=s_l, sweeps=4)
    torch.cuda.synchronize()
    assert P.fused_pcg_ic0.launches == before
    assert not (x.any() or r.any() or p.any() or z.any() or qbuf.any()
                or xin.any())


def _shifted(t, card):
    """A copy of ``t`` one element off its storage's alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _cg_operator(route, card):
    """K9's operator on ``route``: Poisson 64² on the merged word, or
    Poisson 256² widened to a window of 512 tiles on the split planes."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan

    if route == "relsl":
        return S.sell_op_csr(_stencil_csr("poisson64", card))
    csr = _stencil_csr("poisson256", card)
    return S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, 512),
                      device=card)


@pytest.mark.parametrize("what", ["q", "vals", "chunks"])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_cg_refusals(card, route, what):
    """K9's warp-per-sublane SpMV phase, on both routes, refuses a q or a
    values plane one element off its alignment ("misaligned address") and
    planes that are not whole chunks ("invalid argument"): nothing
    launches, no launch is counted, the state is left as it was."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C

    op = _cg_operator(route, card)
    assert op.route == route
    n = C.state_tiles(op.plan) * 128
    b = torch.ones(n, device=card)
    x, r, p = (torch.zeros(n, device=card) for _ in range(3))
    qbuf = torch.zeros(n + 1, device=card)
    q = qbuf[1:] if what == "q" else qbuf[:n]
    planes = C._route_planes(op)
    if what == "vals":
        planes["vals"] = _shifted(planes["vals"], card)
    before = C.fused_cg.launches
    if what != "chunks":
        with pytest.raises(RuntimeError, match="misaligned"):
            C.launch("sell_cg_kernel", op, route=route, planes=planes, b=b,
                     x=x, r=r, p=p, q=q, xin=p, iterations=3)
    else:  # a whole chunk's slots less one sublane: ctypes, past the checks
        lib = C._lib()
        part = torch.zeros(2 * 4096, dtype=torch.float64, device=card)
        meta = planes.get("relsl", planes.get("rel"))
        slice_of = planes.get("slice_of")
        m = op.vals.numel() - 128
        rc = lib.sell_solver_launch(
            0, S._ROUTE_IDS[route], op.vals.data_ptr(), op.lidx.data_ptr(),
            meta.data_ptr(), None if slice_of is None else
            slice_of.data_ptr(), op.tile_base.data_ptr(), b.data_ptr(),
            None, None, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            q.data_ptr(), None, p.data_ptr(), part.data_ptr(), 4096, m, m,
            m, n, op.plan.chunk, 3, 0, 0.0, 0,
            int(op.lidx.dtype == torch.int32), card.index or 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0 and "invalid argument" in lib.sell_error_string(
            rc).decode()
    torch.cuda.synchronize()
    assert C.fused_cg.launches == before
    assert not (x.any() or r.any() or p.any() or qbuf.any())


@pytest.mark.parametrize("steps, tol", [(1, SOLVER_TOL),
                                        (30, SOLVER_TOL_BF16)])
def test_fused_cg_split_planes_bf16_matches_plain(card, steps, tol):
    """K9 on split planes in bfloat16 (the SpMV input rounded to bf16)
    against its plain version, one launch of ``sell_cg_kernel`` counted.
    After one step the SpMV input is b rounded, the same in both, so the
    two differ by the summation order only (1e-4); after 30 the fused
    solvers' drift bound. Three steps are no binding check at this size:
    with 65,536 state entries a one-ulp difference between summation
    orders flips the bf16 rounding of some SpMV input entry within three
    steps, and one-ulp noise on the plain version's q alone moves x by
    1e-4 to 9e-4 there (numpy, Poisson 256²)."""
    import dataclasses

    from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg, fused_cg_plain
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan

    csr = _stencil_csr("poisson256", card)
    csr = dataclasses.replace(csr, vals=csr.vals.to(torch.bfloat16))
    op = S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, 512),
                    value_dtype=torch.bfloat16, device=card)
    assert op.route == "split"
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        csr.shape[0]).astype(np.float32)).to(card)
    before = fused_cg.launches
    got, want = fused_cg(op, b, steps), fused_cg_plain(op, b, steps)
    torch.cuda.synchronize()
    assert fused_cg.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _solver_rel(got, want) <= tol


def test_cli_solve_launches_fused_kernels(card, tmp_path):
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.cli import main
    from smvp_toolkit_tpu_torch.io.mtx import write_mtx
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.utils.synth import poisson2d

    a = sp.tril(poisson2d(40)).tocoo()
    path = str(tmp_path / "p40.mtx")
    write_mtx(path, a.row, a.col, a.data, a.shape, symmetry="symmetric")
    for method, kname in (("cg-fused", "sell_cg_kernel"),
                          ("pcg-ic0-fused", "sell_pcg_ic0_kernel"),
                          ("chebyshev-fused", "sell_chebyshev_kernel")):
        for f in P.SOLVER_KERNELS.values():
            f.launches = 0
        S.sell_spmv.launches = 0
        assert main(["-c", "-n", "3", "--no-report", "--expand-symmetry",
                     "--solve", f"{method}:50", path]) == 0
        counts = {k: f.launches for k, f in P.SOLVER_KERNELS.items()}
        assert counts.pop(kname) == 1 and not any(counts.values())
        assert S.sell_spmv.launches >= 4  # the benchmark and the check


# -- K8 (double-float), K5 and K2-packed -------------------------------------


def _df64_case(lo_plane, chunk=512):
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    rng = np.random.RandomState(0 if lo_plane else 2)
    n, m, nnz = 900, 800, 12000
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    v = rng.randn(nnz) * np.exp2(rng.randint(-8, 8, nnz))
    if not lo_plane:
        v = v.astype(np.float32).astype(np.float64)
    x64 = rng.randn(m)
    return r, c, v, (n, m), x64, lambda dev: SellDf64SpMV.from_coo_f64(
        r, c, v, (n, m), chunk=chunk, device=dev)


@pytest.mark.parametrize("lo_plane", [True, False])
def test_df64_kernels_match_plain_and_oracle(card, lo_plane):
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64

    r, c, v, shape, x64, make = _df64_case(lo_plane)
    op = make(card)
    assert (op.vals_lo is not None) == lo_plane
    xh, xl = df_split(x64, device=card)
    before = (D.sell_df64.launches, D.sell_bench_df64.launches)
    yh, yl = op(xh, xl)
    bh, bl = op.bench_loop(xh, xl, 3)
    ph, pl = D.sell_df64_plain(*op._planes(xh, xl),
                               n_slices=op.plan.n_slices,
                               chunk=op.plan.chunk)
    torch.cuda.synchronize()
    assert (D.sell_df64.launches, D.sell_bench_df64.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(yh, bh) and torch.equal(yl, bl)  # fixed order
    y = df_to_f64(yh, yl)
    n = shape[0]
    yp = df_to_f64(ph[:n], pl[:n])
    scale = np.abs(yp).max()
    assert np.abs(y - yp).max() <= 2.0 ** -50 * scale  # same order: 0
    oracle = np.zeros(n)
    np.add.at(oracle, r, v * x64[c])
    assert np.abs(y - oracle).max() <= 5e-14 * np.abs(oracle).max()


def test_df64_edge_scales_exact_on_card(card):
    from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    def run(v64, cols, n=4):
        v64 = np.asarray(v64, np.float64)
        op = SellDf64SpMV.from_coo_f64(np.zeros(len(v64), np.int64),
                                       np.asarray(cols), v64, (n, n),
                                       chunk=8, device=card)
        return df_to_f64(*op(*df_split(np.ones(n), device=card)))[0]

    assert run([0.0], [0]) == 0.0
    # the low words of 1e-35 and 2e-35 are float32 subnormals (2^-149)
    assert abs(run([1e-35, 2e-35], [0, 1]) - 3e-35) <= 3 * 2.0 ** -149
    assert run([1e30, -1e30, 3.0], [0, 1, 2]) == 3.0


@pytest.mark.parametrize("route", ["relsl", "streamy_relsl"])
def test_packed_kernels_match_plain(card, route, monkeypatch):
    op = S.SellSpMV(_route_plan(route), value_dtype=torch.bfloat16,
                    device=card)
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    assert op.route == ("packed" if route == "relsl" else "streamy_packed")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        op.plan.shape[1]).astype(np.float32)).to(card)
    xt = op._x_tiles(x)
    pk, sl = op.packed_planes()
    kw = op._kw()
    if "nsb" in kw:
        kw["y_block_id"] = op.y_block_id
    before = {n: f.launches for n, f in S.PACKED_KERNELS.items()}
    y1 = S.sell_packed(pk, sl, op.tile_base, xt, **kw)
    yp = S.sell_packed_plain(pk, sl, op.tile_base, xt, **kw)
    y_k1 = op.kernel(*op._planes(), xt, **op._kw())
    want = {"sell_packed_kernel": 1}
    if route == "relsl":
        y2 = S.sell_bench_packed(pk, sl, op.tile_base, xt, iterations=3,
                                 **op._kw())
        want["sell_bench_packed_kernel"] = 1
        for k in (2, 8, 17):
            X = _block(card, op.plan.n_coltiles * 128, k, k, torch.bfloat16)
            Y = S.sell_packed_spmm(pk, sl, op.tile_base, X,
                                   **op._mat_kw())
            Yp = S.sell_packed_spmm_plain(pk, sl, op.tile_base, X,
                                          **op._mat_kw())
            assert _rel(Y, Yp) <= TOL
        want["sell_packed_spmm_kernel"] = 3
    torch.cuda.synchronize()
    after = {n: f.launches - before[n] for n, f in S.PACKED_KERNELS.items()}
    assert after == {n: want.get(n, 0) for n in S.PACKED_KERNELS}
    assert _rel(y1, yp) <= TOL and _rel(y1, y_k1) <= TOL
    if route == "relsl":
        assert _rel(y2, yp) <= TOL
    else:
        with pytest.raises(ValueError, match="streamed-y bench_loop"):
            op.bench_loop(x, 2)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_k2_packed_matches_plain_at_each_n(card, iterations):
    """K2-packed's two y buffers: N = 1 and 3 end in buffer 0, N = 2 in
    buffer 1; each equals the plain version and one K5 launch."""
    op = S.SellSpMV(_route_plan("relsl"), value_dtype=torch.bfloat16,
                    device=card)
    pk, sl = op.packed_planes()
    xt = op._x_tiles(torch.from_numpy(np.random.default_rng(
        iterations).standard_normal(op.plan.shape[1]).astype(
        np.float32)).to(card))
    before = S.sell_bench_packed.launches
    y = S.sell_bench_packed(pk, sl, op.tile_base, xt, iterations=iterations,
                            **op._kw())
    yp = S.sell_bench_packed_plain(pk, sl, op.tile_base, xt,
                                   iterations=iterations, **op._kw())
    y1 = S.sell_packed(pk, sl, op.tile_base, xt, **op._kw())
    torch.cuda.synchronize()
    assert S.sell_bench_packed.launches == before + 1
    assert S.PACKED_BENCH_Y_BUFFERS == 2
    assert y.shape == yp.shape and bool(torch.isfinite(y).all())
    assert _rel(y, yp) <= TOL and _rel(y, y1) <= TOL


@pytest.mark.parametrize("route", ["relsl", "streamy_relsl"])
def test_packed_disagreeing_lanes_follow_lane_zero(card, route):
    """K5 and K2-packed stage rel from lane 0's word, and K5 with k columns
    decodes it from there: on a plane whose lanes 1..127 carry another rel
    (odd lanes 511, even lanes another tile) each equals the plain version
    on that plane, which reads lane 0, and the plane's own y."""
    import torch_packed_plans as pp

    op = S.SellSpMV(_route_plan(route), value_dtype=torch.bfloat16,
                    device=card)
    pk, sl = op.packed_planes()
    bad = torch.from_numpy(pp.disagreeing_lanes(
        pk.cpu().numpy(), sl.cpu().numpy(), op.tile_base.cpu().numpy(),
        chunk=op.plan.chunk, n_coltiles=op.plan.n_coltiles)).to(card)
    assert not torch.equal(bad, pk)
    kw = op._kw()
    if "nsb" in kw:
        kw["y_block_id"] = op.y_block_id
    xt = op._x_tiles(torch.from_numpy(np.random.default_rng(4).standard_normal(
        op.plan.shape[1]).astype(np.float32)).to(card))
    y = S.sell_packed(bad, sl, op.tile_base, xt, **kw)
    yp = S.sell_packed_plain(bad, sl, op.tile_base, xt, **kw)
    y_own = S.sell_packed(pk, sl, op.tile_base, xt, **kw)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= TOL and _rel(y, y_own) <= TOL
    if route != "relsl":
        return
    for n in (2, 3):
        y = S.sell_bench_packed(bad, sl, op.tile_base, xt, iterations=n,
                                **kw)
        yp = S.sell_bench_packed_plain(bad, sl, op.tile_base, xt,
                                       iterations=n, **kw)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= TOL and _rel(y, y_own) <= TOL, n
    tol = spmm_tolerance(op.plan)[0]
    for k in (1, 3, 8):
        X = _block(card, op.plan.n_coltiles * 128, k, k, torch.bfloat16)
        Y = S.sell_packed_spmm(bad, sl, op.tile_base, X, **op._mat_kw())
        Yp = S.sell_packed_spmm_plain(bad, sl, op.tile_base, X,
                                      **op._mat_kw())
        Y_own = S.sell_packed_spmm_plain(pk, sl, op.tile_base, X,
                                         **op._mat_kw())
        torch.cuda.synchronize()
        assert _rel(Y, Yp) <= tol and _rel(Y, Y_own) <= tol, k


@pytest.mark.parametrize("chunk", [2048, 200])
def test_packed_split_launch_views_match_plain(card, chunk, monkeypatch):
    """SMVP_SELL_PACK=1 with SMVP_SELL_SPLIT=3: K5 launches on views of the
    packed planes cut at chunk boundaries (512 bytes a sublane, so still
    aligned for its 16-byte loads), summed to the plain version's y."""
    plan = _plan(chunk)
    op = S.SellSpMV(plan, value_dtype=torch.bfloat16, device=card)
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    assert op.route == "packed" and plan.n_chunks >= 3
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    pk, sl = op.packed_planes()
    yp = S.sell_packed_plain(pk, sl, op.tile_base, op._x_tiles(x),
                             **op._kw())
    monkeypatch.setenv("SMVP_SELL_SPLIT", "3")
    before = S.sell_packed.launches
    y = op(x)
    torch.cuda.synchronize()
    assert S.sell_packed.launches == before + 3
    assert _rel(y, yp[: plan.shape[0]]) <= TOL


@pytest.mark.parametrize("what", ["packed", "y", "empty"])
@pytest.mark.parametrize("route", ["relsl", "streamy_relsl"])
def test_packed_refusals(card, route, what):
    """K5, and on the resident plan K2-packed, refuse a packed plane or a y
    one word off 16 bytes ("misaligned address") and planes of no sublane
    ("invalid argument"): nothing launches, no launch is counted, nothing
    falls back."""
    from smvp_toolkit_tpu_torch.ops import _build

    op = S.SellSpMV(_route_plan(route), value_dtype=torch.bfloat16,
                    device=card)
    pk, sl = op.packed_planes()
    tb, yb = op.tile_base, op.y_block_id
    kw = op._kw()
    xt = op._x_tiles(torch.ones(op.plan.shape[1], device=card))
    n_out = kw["n_slices"] * 128
    y = torch.zeros(n_out + 4, dtype=torch.float32, device=card)
    match = "misaligned"
    if what == "packed":
        flat = torch.empty(pk.numel() + 1, dtype=pk.dtype, device=card)
        pk = flat[1:].view(pk.shape)
        pk.copy_(op.packed_planes()[0])
    elif what == "empty":
        pk, sl, tb = pk[:0], sl[:0], tb[:0]
        yb = None if yb is None else yb[:0]
        match = "invalid argument"
    out = y[1:] if what == "y" else y
    before = S.sell_packed.launches
    if what != "y":
        with pytest.raises(RuntimeError, match=match):
            S.sell_packed(pk, sl, tb, xt, **kw,
                          **({"y_block_id": yb} if yb is not None else {}))
        assert S.sell_packed.launches == before
    lib = _build.load("sell_packed", S._PACKED_SIGNATURES)
    rc = lib.sell_packed_launch(
        pk.data_ptr(), sl.data_ptr(), tb.data_ptr(),
        None if yb is None else yb.data_ptr(), xt.data_ptr(),
        out.data_ptr(), pk.numel(), kw["chunk"], kw.get("nsb", 0),
        card.index or 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0 and match in lib.sell_error_string(rc).decode()
    assert not y.any()
    if route != "relsl":
        return
    before = S.sell_bench_packed.launches
    if what != "y":
        with pytest.raises(RuntimeError, match=match):
            S.sell_bench_packed(pk, sl, tb, xt, iterations=2, **kw)
        assert S.sell_bench_packed.launches == before
    ys = torch.zeros(2 * n_out + 4, dtype=torch.float32, device=card)
    rc = lib.sell_bench_packed_launch(
        pk.data_ptr(), sl.data_ptr(), tb.data_ptr(), xt.data_ptr(),
        (ys[1:] if what == "y" else ys).data_ptr(), pk.numel(), n_out,
        kw["chunk"], 2, card.index or 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0 and match in lib.sell_error_string(rc).decode()
    assert not ys.any()


def _packed_spmm_case(name, card):
    """A bf16 operator for K5 with k columns: the small resident plan, or
    the hub-row plan (200 duplicate sublanes of one row, runs cut at 16
    and across work items)."""
    plan = (_route_plan("relsl") if name == "small"
            else kcol_plans.hub_row_plan("relsl"))
    return S.SellSpMV(plan, value_dtype=torch.bfloat16, device=card)


@pytest.mark.parametrize("k", [2, 8, 17])
@pytest.mark.parametrize("plan_name", ["small", "hub-row"])
def test_packed_spmm_matches_plain_and_k1(card, plan_name, k):
    """K5 with k columns on the k-column body: one launch, equal to its
    plain version and to K1 with k columns in bf16 on the same plan within
    the plan's SpMM tolerance (the products are bit-equal; only the
    summation order differs)."""
    op = _packed_spmm_case(plan_name, card)
    pk, sl = op.packed_planes()
    kw = op._mat_kw()
    X = _block(card, op.plan.n_coltiles * 128, k, k, torch.bfloat16)
    tol = spmm_tolerance(op.plan)[0]
    before = S.sell_packed_spmm.launches
    Y = S.sell_packed_spmm(pk, sl, op.tile_base, X, **kw)
    Yp = S.sell_packed_spmm_plain(pk, sl, op.tile_base, X, **kw)
    Y1 = op.spmm_kernel(*op._planes(), X, **kw)
    torch.cuda.synchronize()
    assert S.sell_packed_spmm.launches == before + 1
    assert Y.shape == (op.plan.n_slices * 128, k)
    assert bool(torch.isfinite(Y).all())
    assert _rel(Y, Yp) <= tol and _rel(Y, Y1) <= tol


@pytest.mark.parametrize("plane", ["disagreeing-lanes", "dead-lane-zero"])
@pytest.mark.parametrize("k", [6, 8])
def test_packed_spmm_disagreeing_lanes_skip_inf(card, k, plane):
    """On a plane whose lanes 1..127 carry another rel than lane 0's, or
    whose every third live sublane has a dead lane-0 rel (the reference
    drops it; the kernel's shuffle clears its mask), with Inf in X at a
    padding lane's column and every real entry of that column given value
    bits 0 in its word: Y stays finite and equals the plain version on
    that plane (rel from lane 0; zero values never multiplied), in the
    vector (k = 8) and scalar (k = 6) forms."""
    import torch_packed_plans as pp

    op = _packed_spmm_case("small", card)
    plan = op.plan
    pk, sl = op.packed_planes()
    if plane == "disagreeing-lanes":
        bad = pp.disagreeing_lanes(
            pk.cpu().numpy(), sl.cpu().numpy(), op.tile_base.cpu().numpy(),
            chunk=plan.chunk, n_coltiles=plan.n_coltiles).reshape(-1, 128)
    else:
        bad = pk.cpu().numpy().reshape(-1, 128).copy()
        dead = np.flatnonzero((pp.word_rel(bad)[:, 0] != pp.REL_DEAD)
                              & (sl.cpu().numpy() >= 0))[::3]
        bad[dead, 0] |= pp.REL_DEAD << pp.REL_SHIFT
    vals = plan.vals.reshape(-1, 128)
    live = (plan.rel_tile.reshape(-1) >= 0) & (plan.slice_of.reshape(-1) >= 0)
    s = np.arange(vals.shape[0])
    cols = ((plan.tile_base.astype(np.int64)[s // plan.chunk]
             + plan.rel_tile.reshape(-1))[:, None] * 128
            + plan.lane_idx.reshape(vals.shape))
    col = int(cols[live[:, None] & (vals == 0)][0])
    bad[live[:, None] & (vals != 0) & (cols == col)] &= 0xFFFF
    bad = torch.from_numpy(bad.reshape(pk.shape)).to(card)
    X = _block(card, plan.n_coltiles * 128, k, 9, torch.bfloat16)
    X[col] = float("inf")
    Y = S.sell_packed_spmm(bad, sl, op.tile_base, X, **op._mat_kw())
    Yp = S.sell_packed_spmm_plain(bad, sl, op.tile_base, X, **op._mat_kw())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Y).all()) and bool(torch.isfinite(Yp).all())
    assert _rel(Y, Yp) <= spmm_tolerance(plan)[0]


@pytest.mark.parametrize("what", ["packed", "X", "empty"])
def test_packed_spmm_refusals(card, what):
    """K5 with k columns refuses a packed plane one word off 16 bytes and,
    at k = 8 (the vector form), an X one element off four
    ("misaligned address"), and planes of no sublane ("invalid
    argument"): nothing launches, no launch is counted. At k = 6 (the
    scalar form) the shifted X launches and equals the plain version."""
    from smvp_toolkit_tpu_torch.ops import _build

    op = _packed_spmm_case("small", card)
    pk, sl = op.packed_planes()
    tb = op.tile_base
    kw = op._mat_kw()
    match = "invalid argument" if what == "empty" else "misaligned"
    if what == "packed":
        pk = _shifted(pk, card)
    elif what == "empty":
        pk, sl, tb = pk[:0], sl[:0], tb[:0]
    X = _block(card, op.plan.n_coltiles * 128, 8, 3, torch.bfloat16)
    if what == "X":
        X = _shifted(X, card)
    before = S.sell_packed_spmm.launches
    with pytest.raises(RuntimeError, match=match):
        S.sell_packed_spmm(pk, sl, tb, X, **kw)
    assert S.sell_packed_spmm.launches == before
    Y = torch.zeros(kw["n_slices"] * 128, 8, device=card)
    lib = _build.load("sell_packed", S._PACKED_SIGNATURES)
    rc = lib.sell_packed_spmm_launch(
        pk.data_ptr(), sl.data_ptr(), tb.data_ptr(), X.data_ptr(),
        Y.data_ptr(), pk.numel(), kw["chunk"], 8, card.index or 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0 and match in lib.sell_error_string(rc).decode()
    assert not Y.any()
    if what == "X":
        X6 = _shifted(_block(card, op.plan.n_coltiles * 128, 6, 3,
                             torch.bfloat16), card)
        Y6 = S.sell_packed_spmm(pk, sl, tb, X6, **kw)
        torch.cuda.synchronize()
        assert S.sell_packed_spmm.launches == before + 1
        assert _rel(Y6, S.sell_packed_spmm_plain(pk, sl, tb, X6, **kw)) <= (
            spmm_tolerance(op.plan)[0])


def _df64_plan_case(name, lo_plane):
    """(operator maker, x64) of K8's edge plans: the hub row (258 live
    sublanes in one slice, 8 empty slices, int32 lanes at its chunk of
    1544), empty slices (chunk 256, int8 lanes), slices straddling chunks
    (chunk 64) and int32 lanes at chunk 200."""
    import torch_kcol_plans as kcol

    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "hub-row":
        r, c, v, shape, chunk = kcol.hub_row_triplets("relsl")
    elif name == "empty-slices":
        n, m, nnz = 2048, 1500, 9000
        r = (rng.choice(np.arange(0, n // 128, 3), nnz) * 128
             + rng.randint(0, 128, nnz))
        c, v, shape, chunk = rng.randint(0, m, nnz), rng.randn(nnz), (
            n, m), 256
    else:
        n, m, nnz = 900, 800, 12000
        r, c, v = rng.randint(0, n, nnz), rng.randint(0, m, nnz), \
            rng.randn(nnz)
        shape, chunk = (n, m), (64 if name == "straddle" else 200)
    if not lo_plane:
        v = v.astype(np.float32).astype(np.float64)
    return (lambda dev: SellDf64SpMV.from_coo_f64(
        r, c, v, shape, chunk=chunk, device=dev)), rng.randn(shape[1])


@pytest.mark.parametrize("name", ["hub-row", "empty-slices", "straddle",
                                  "int32-lidx"])
@pytest.mark.parametrize("lo_plane", [True, False])
def test_df64_staged_walk_bit_equal(card, name, lo_plane):
    """K8 on staged slice metadata on its edge plans: bit for bit its plain
    version, with and without a lo plane, int8 and int32 lanes; its
    N-iteration launch bit for bit one launch."""
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_split

    make, x64 = _df64_plan_case(name, lo_plane)
    op = make(card)
    assert (op.vals_lo is not None) == lo_plane
    counts = torch.diff(op.slice_ptr.long())
    if name == "hub-row":
        assert counts.max() == 258 and (counts == 0).sum() == 8
    if name in ("hub-row", "int32-lidx"):
        assert op.lidx.dtype == torch.int32
    xh, xl = df_split(x64, device=card)
    planes = op._planes(xh, xl)
    kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
    y = D.sell_df64(*planes, **kw)
    y3 = D.sell_bench_df64(*planes, iterations=3, **kw)
    yp = D.sell_df64_plain(*planes, **kw)
    torch.cuda.synchronize()
    for a, b in ((y, yp), (y3, y)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("lo_plane", [True, False])
def test_df64_writes_every_word(card, lo_plane):
    """Launched into y buffers full of NaN, K8 and its N-iteration kernel
    write every word: equal to the plain version, the rows of empty slices
    0."""
    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_split

    make, x64 = _df64_plan_case("hub-row", lo_plane)
    op = make(card)
    planes = op._planes(*df_split(x64, device=card))
    kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
    ph, pl = D.sell_df64_plain(*planes, **kw)
    lib = _build.load("sell_df64", D._SIGNATURES)
    ptrs = [None if t is None else t.data_ptr() for t in planes]
    n_rows = op.plan.n_slices * 128
    lk = int(op.lidx.dtype == torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    empty = torch.diff(op.slice_ptr.long()) == 0
    assert empty.any()
    for bench in (False, True):
        yh, yl = (torch.full((n_rows,), float("nan"), device=card)
                  for _ in range(2))
        if bench:
            rc = lib.sell_bench_df64_launch(
                *ptrs, yh.data_ptr(), yl.data_ptr(), n_rows, kw["chunk"], 2,
                lk, card.index or 0, stream)
        else:
            rc = lib.sell_df64_launch(
                *ptrs, yh.data_ptr(), yl.data_ptr(), n_rows, kw["chunk"], lk,
                card.index or 0, stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.isfinite(yh).all() and torch.isfinite(yl).all()
        assert torch.equal(yh, ph) and torch.equal(yl, pl)
        assert not yh.view(-1, 128)[empty].any()


def test_packed_gates_on_card(card, monkeypatch):
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    split = S.SellSpMV(_route_plan("split"), value_dtype=torch.bfloat16,
                       device=card)
    f32 = S.SellSpMV(_route_plan("relsl"), device=card)
    assert split.route == "split" and f32.route == "relsl"
    before = {n: f.launches for n, f in S.PACKED_KERNELS.items()}
    for op in (split, f32):
        op(torch.ones(op.plan.shape[1], device=card))
    torch.cuda.synchronize()
    assert {n: f.launches for n, f in S.PACKED_KERNELS.items()} == before


def test_cli_df64_and_packed_launch_their_kernels(card, tmp_path,
                                                   monkeypatch):
    from smvp_toolkit_tpu_torch.cli import main
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D

    D.sell_df64.launches = D.sell_bench_df64.launches = 0
    assert main(["-c", "-n", "5", "--kernel", "df64", "--no-report",
                 "synth:20000:200000"]) == 0
    assert D.sell_df64.launches >= 5 and D.sell_bench_df64.launches == 0
    assert main(["-c", "-n", "5", "--kernel", "df64", "--fused",
                 "--no-report", "synth:20000:200000"]) == 0
    assert D.sell_bench_df64.launches >= 1
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    for f in S.PACKED_KERNELS.values():
        f.launches = 0
    S.sell_spmv.launches = 0
    assert main(["-c", "-n", "5", "--dtype", "bfloat16", "--no-report",
                 "synth:20000:200000"]) == 0
    assert main(["-c", "-n", "5", "--dtype", "bfloat16", "--fused",
                 "--no-report", "synth:20000:200000"]) == 0
    assert S.sell_packed.launches >= 5 and S.sell_bench_packed.launches >= 1
    assert S.sell_spmv.launches == 0


# -- K6 (SMVP_SELL_COMPAT=1), K2-subwin (SMVP_SELL_SUBWIN=1), the
# co-clustered operator and the other switches ------------------------------


def _onehot_args(op, x):
    return (op.vals, op.lidx, *op.split_planes(), op.tile_base,
            op._x_tiles(x))


@pytest.mark.parametrize("chunk", [2048, 200])  # int8 / int32 lane indices
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_kernel_matches_plain(card, chunk, dtype, monkeypatch):
    plan = _plan(chunk)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    monkeypatch.setenv("SMVP_SELL_COMPAT", "1")
    assert op.route == "onehot"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    args, kw = _onehot_args(op, x), op._onehot_kw()
    before = S.sell_onehot.launches
    y = S.sell_onehot(*args, **kw)
    y_call = op(x)
    yp = S.sell_onehot_plain(*args, **kw)
    y_k1 = op.kernel(*op._planes(), op._x_tiles(x), **op._kw())
    torch.cuda.synchronize()
    assert S.sell_onehot.launches == before + 2
    assert _rel(y, yp) <= TOL and _rel(y, y_k1) <= TOL
    assert torch.equal(y_call, y[: plan.shape[0]])  # one fixed order
    # a wrong slice_of shows (the index is rebuilt from it)
    rel, sl = op.split_planes()
    s = int(np.nonzero(plan.slice_of.reshape(-1) >= 0)[0][3])
    bad = sl.clone()
    bad[s] = (sl[s] + 1) % plan.n_slices
    assert _rel(S.sell_onehot(op.vals, op.lidx, rel, bad, op.tile_base,
                              args[-1], **{**kw, "index": None}), yp) > 1e-4


@pytest.fixture(scope="module")
def onehot_variants():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smvp_toolkit_tpu_torch.bench.bench_variants import (
        build_onehot_variants,
    )

    return build_onehot_variants()[0]


@pytest.mark.parametrize("chunk", [2048, 200])  # int8 / int32 lane indices
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_kernel_bit_for_bit_the_dense_kernel(card, onehot_variants,
                                                     chunk, dtype):
    """K6 on the plan's planes equals, bit for bit, the dense-operand
    kernel it replaced (csrc/variants/sell_onehot_variants.cu), and so do
    the variants' staged and warp forms."""
    from smvp_toolkit_tpu_torch.bench.bench_variants import (
        ONEHOT_FORMS,
        onehot_dense_launcher,
        onehot_variant_launcher,
    )

    plan = _plan(chunk)
    op = S.SellSpMV(plan, value_dtype=dtype, device=card)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        plan.shape[1]).astype(np.float32)).to(card)
    args, kw = _onehot_args(op, x), op._onehot_kw()
    y = S.sell_onehot(*args, **kw)
    yd = onehot_dense_launcher(onehot_variants, *args, **kw)()
    form = onehot_variant_launcher(onehot_variants, *args, **kw)
    forms = [form(*f) for f in ONEHOT_FORMS]
    torch.cuda.synchronize()
    assert torch.equal(y, yd)
    assert all(torch.equal(y, f) for f in forms)


def test_onehot_hub_slice_matches_plain(card, onehot_variants):
    """A plan with one slice of 2,100 live sublanes (a row of 2,100
    products): one block walks it in passes of 128 entries, against the plain version
    and, bit for bit, the dense-operand kernel."""
    from smvp_toolkit_tpu_torch.bench.bench_variants import (
        onehot_dense_launcher,
    )

    rng = np.random.RandomState(5)
    r, c = rng.randint(0, 3000, 20000), rng.randint(0, 3000, 20000)
    r = np.concatenate([r, np.full(2100, 1000)])
    c = np.concatenate([c, rng.choice(3000, 2100, replace=False)])
    plan = build_sell_plan(r, c, rng.randn(r.size), (3000, 3000), chunk=256)
    for dtype in (torch.float32, torch.bfloat16):
        op = S.SellSpMV(plan, value_dtype=dtype, device=card)
        ptr = op.slice_index()[0]
        assert int((ptr[1:] - ptr[:-1]).max()) >= 2000
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            3000).astype(np.float32)).to(card)
        args, kw = _onehot_args(op, x), op._onehot_kw()
        y = S.sell_onehot(*args, **kw)
        yp = S.sell_onehot_plain(*args, **kw)
        yd = onehot_dense_launcher(onehot_variants, *args, **kw)()
        torch.cuda.synchronize()
        assert _rel(y, yp) <= TOL and torch.equal(y, yd)


def test_onehot_refuses_misaligned_vals(card):
    """A values view one element off 16 bytes raises; nothing launches."""
    plan = _plan(2048)
    op = S.SellSpMV(plan, device=card)
    x = torch.ones(plan.shape[1], device=card)
    args, kw = list(_onehot_args(op, x)), op._onehot_kw()
    store = torch.empty(op.vals.numel() + 1, dtype=op.vals.dtype,
                        device=card)
    args[0] = store[1:].view_as(op.vals)
    args[0].copy_(op.vals)
    before = S.sell_onehot.launches
    with pytest.raises(RuntimeError, match="misaligned address"):
        S.sell_onehot(*args, **kw)
    assert S.sell_onehot.launches == before


def _subwin_plan(chunk):
    rng = np.random.RandomState(chunk + 1)
    n, nnz = 40000, 400000
    r = rng.randint(0, n, nnz)
    c = np.clip(r + rng.randint(-300, 301, nnz), 0, n - 1)
    return build_sell_plan(r, c, rng.randn(nnz), (n, n), chunk=chunk)


@pytest.mark.parametrize("chunk", [2048, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subwin_kernel_matches_plain_and_k2(card, chunk, dtype,
                                            monkeypatch):
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    if chunk < 2048:
        monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
    op = S.SellSpMV(_subwin_plan(chunk), value_dtype=dtype, device=card)
    assert op.bench_route == "subwin"
    stb, ssb, split, sub_wt, sub_nsw = op.subwin_windows()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        op.plan.shape[1]).astype(np.float32)).to(card)
    xt = op._x_tiles(x)
    planes = (op.vals, op.lidx, op.relsl, op.tile_base)
    kw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=3,
              **op._kw())
    before = S.sell_bench_subwin.launches
    y = S.sell_bench_subwin(*planes, stb, ssb, xt, **kw)
    y_loop = op.bench_loop(x, 3)
    yp = S.sell_bench_subwin_plain(*planes, stb, ssb, xt, **kw)
    y_k2 = S.sell_bench_loop(*planes, xt, iterations=3, **op._kw())
    bad = S.sell_bench_subwin(*planes, stb + 16, ssb, xt, **kw)
    # N = 1 and 2 end in the two y buffers in turn
    ys = [S.sell_bench_subwin(*planes, stb, ssb, xt, **{**kw, "iterations": n})
          for n in (1, 2)]
    torch.cuda.synchronize()
    assert S.sell_bench_subwin.launches == before + 5
    assert _rel(y, yp) <= TOL and _rel(y, y_k2) <= TOL
    assert all(_rel(v, yp) <= TOL for v in ys)
    assert _rel(y_loop, y_k2[: op.shape[0]]) <= TOL
    assert _rel(bad, y_k2) > TOL


@pytest.mark.parametrize("what", ["vals", "lidx", "empty"])
def test_subwin_refusals(card, what, monkeypatch):
    """K2-subwin refuses a values or lane-index plane one element off its
    vector loads' alignment ("misaligned address") and planes of no
    sublane ("invalid argument"), as K2 does, counting no launch."""
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    op = S.SellSpMV(_subwin_plan(2048), device=card)
    stb, ssb, split, sub_wt, sub_nsw = op.subwin_windows()
    xt = op._x_tiles(torch.ones(op.plan.shape[1], device=card))
    planes = [op.vals, op.lidx, op.relsl, op.tile_base]
    match = "misaligned"
    if what == "empty":
        planes = [t[:0] for t in planes]
        stb, ssb = stb[:0], ssb[:0]
        match = "invalid argument"
    else:
        i = 0 if what == "vals" else 1
        flat = torch.empty(planes[i].numel() + 1, dtype=planes[i].dtype,
                           device=card)
        view = flat[1:].view(planes[i].shape)
        view.copy_(planes[i])
        planes[i] = view
    before = S.sell_bench_subwin.launches
    with pytest.raises(RuntimeError, match=match):
        S.sell_bench_subwin(*planes, stb, ssb, xt, split=split,
                            sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=2,
                            **op._kw())
    assert S.sell_bench_subwin.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coclustered_operator_on_card(card, dtype):
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    rng = np.random.default_rng(3)
    n, nnz = 3000, 24000
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-300, 301, nnz), 0, n - 1)
    v = rng.standard_normal(nnz)
    coo = COOMatrix.from_numpy(r, c, v, shape=(n, n), device="cpu")
    cpu = S.CoClusteredSellSpMV(coo, value_dtype=dtype, passes=4)
    gpu = S.CoClusteredSellSpMV(coo, value_dtype=dtype, device=card,
                                passes=4)
    assert gpu.result is cpu.result
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    before = (S.sell_spmv.launches, S.sell_bench_loop.launches)
    y = gpu(torch.from_numpy(x).to(card))
    xp = gpu.to_permuted(torch.from_numpy(x).to(card))
    yb = gpu.bench_loop(xp, 3)
    torch.cuda.synchronize()
    assert (S.sell_spmv.launches, S.sell_bench_loop.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(y.cpu(), cpu(torch.from_numpy(x))) <= TOL
    assert _rel(yb.cpu(), cpu.bench_loop(cpu.to_permuted(
        torch.from_numpy(x)), 1)) <= TOL


def test_cli_cocluster_and_switches_launch_their_kernels(card, monkeypatch):
    from smvp_toolkit_tpu_torch.cli import main

    fns = {"sell_spmv_kernel": S.sell_spmv,
           "sell_bench_kernel": S.sell_bench_loop,
           "sell_split_kernel": S.sell_split, **S.SWITCH_KERNELS}

    def run(argv, env=None, spec="synth:20000:200000"):
        for f in fns.values():
            f.launches = 0
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        assert main(argv + ["--no-report", spec]) == 0
        for k in env or {}:
            monkeypatch.delenv(k)
        return {n: f.launches for n, f in fns.items() if f.launches}

    got = run(["-c", "-n", "5", "--cocluster", "--fused", "--dtype",
               "bfloat16"])
    assert set(got) == {"sell_bench_kernel"}
    got = run(["-c", "-n", "5", "--cocluster"])
    assert set(got) == {"sell_spmv_kernel"} and got["sell_spmv_kernel"] >= 5
    assert set(run(["-c", "-n", "5"], {"SMVP_SELL_COMPAT": "1"})) == {
        "sell_onehot_kernel"}
    assert set(run(["-c", "-n", "5"], {"SMVP_SELL_RELSL": "0"})) == {
        "sell_split_kernel"}
    assert set(run(["-c", "-n", "5", "--fused"],
                   {"SMVP_SELL_SUBWIN": "1"})) == {"sell_bench_subwin_kernel"}
    big = "synth:100000:1000000"  # 10 chunks of 2048
    split = run(["-c", "-n", "5"], {"SMVP_SELL_SPLIT": "4"}, big)
    plain = run(["-c", "-n", "5"], spec=big)
    assert set(split) == set(plain) == {"sell_spmv_kernel"}
    assert split["sell_spmv_kernel"] == 4 * plain["sell_spmv_kernel"]


def _dist_coo(dtype=torch.float32):
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    rng = np.random.RandomState(11)
    n, m, nnz = 9000, 14000, 120000
    r = rng.randint(0, n // 2, size=nnz) * 2
    c = rng.randint(0, m, size=nnz)
    return COOMatrix.from_numpy(r, c, rng.randn(nnz), shape=(n, m),
                                dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_sharded_per_shard_matches_plain_and_k2(card, dtype):
    """A 4-shard plan (chunk 1024, int8 lanes), each shard launched in turn
    on the card as its rank would: K2-sharded (N = 3) against its plain
    version per shard, and the shards' rows in rank order against the
    unsharded K2; in the wrong order they miss."""
    from smvp_toolkit_tpu_torch.parallel import sell_dist as SD
    from smvp_toolkit_tpu_torch.parallel.mesh import Mesh

    coo = _dist_coo(dtype)
    sh = SD.shard_sell(coo, Mesh(4, 0, card), value_dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        coo.shape[1]).astype(np.float32)).to(card)
    before = SD.bench_loop_sharded.launches
    ys = []
    for k in range(4):
        s = sh.for_rank(k, card)
        assert s.op.lidx.dtype == torch.int8 and s.op.relsl is not None
        y = SD._local_bench(s, x, 3)
        yp = S.sell_bench_loop_plain(
            s.op.vals, s.op.lidx, s.op.relsl, s.op.tile_base,
            s.op._x_tiles(x), n_slices=s.NSl, chunk=s.chunk, iterations=3)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= TOL
        ys.append(y[: sh.rows_per_shard])
    assert SD.bench_loop_sharded.launches == before + 4
    ref = S.SellSpMV.from_coo(coo, value_dtype=dtype, device=card)
    want = ref.bench_loop(x, 3)
    assert _rel(torch.cat(ys)[: coo.shape[0]], want) <= TOL
    assert _rel(torch.cat(ys[::-1])[: coo.shape[0]], want) > TOL


def test_one_rank_nccl_group(card, monkeypatch):
    """A real one-rank NCCL group: the sharded SpMV (K1 and NCCL
    all-gather), K2-sharded and the striped TJDS (NCCL all-reduce)
    against the unsharded operator."""
    import socket

    import torch.distributed as dist

    from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
    from smvp_toolkit_tpu_torch.parallel import (
        distributed_init,
        make_mesh,
        shard_sell,
        shard_tjds,
        spmv_sell_sharded,
        spmv_tjds_sharded,
    )
    from smvp_toolkit_tpu_torch.parallel.sell_dist import bench_loop_sharded

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    assert distributed_init()
    try:
        assert dist.get_backend() == "nccl" and distributed_init()
        mesh = make_mesh()
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0, card)
        coo = _dist_coo()
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            coo.shape[1]).astype(np.float32)).to(card)
        want = S.SellSpMV.from_coo(coo, device=card)(x)
        sh = shard_sell(coo, mesh)
        before = S.sell_spmv.launches
        assert _rel(spmv_sell_sharded(sh, x, mesh), want) <= TOL
        assert S.sell_spmv.launches == before + 1
        assert _rel(bench_loop_sharded(sh, x, mesh, 3), want) <= TOL
        coo_card = _dist_coo()
        tj = tjds_encode(type(coo_card).from_numpy(
            *coo_card.to_numpy(), shape=coo_card.shape, device=card))
        assert _rel(spmv_tjds_sharded(shard_tjds(tj, mesh), x, mesh),
                    want) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("slots", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cisr_replan_on_card(card, slots, dtype):
    """spmv_cisr_sell on the card (K1 per call, K2 in bench_loop) against
    the schedule's own SpMV (CisrSpMV) and CSR's y on the same matrix."""
    from smvp_toolkit_tpu_torch.formats.cisr import cisr_encode
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.ops.spmv_cisr import CisrSpMV

    rng = np.random.default_rng(slots)
    n, m, nnz = 20000, 15000, 200000
    r = rng.integers(0, n // 3, nnz) * 3  # two rows of three empty
    c = rng.integers(0, m, nnz)
    coo = COOMatrix.from_numpy(r, c, rng.standard_normal(nnz), shape=(n, m),
                               dtype=dtype, device=card).pad(128)
    cisr = cisr_encode(coo, slots)
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        dtype).to(card)
    k1 = S.KERNEL_NAMES[("relsl", False)]
    fn = S._ROUTE_FNS["relsl"][0]
    fn.launches = 0
    y = S.spmv_cisr_sell(cisr, x)
    torch.cuda.synchronize()
    assert fn.launches == 1, k1
    assert y.shape == (n,) and y.device == card
    y_sched = CisrSpMV(cisr, device=card)(x.float())
    assert _rel(y.float(), y_sched) <= TOL
    y_csr = S.spmv_csr_sell(csr_encode(coo), x)
    assert _rel(y.float(), y_csr.float()) <= TOL
    op = S.sell_op_cisr(cisr, card)
    assert _rel(op.bench_loop(x, 3).float(), y_sched) <= TOL


def _poisson_csr(nx, device):
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.interop import coo_from_triplets
    from smvp_toolkit_tpu_torch.utils.synth import poisson2d

    a = poisson2d(nx).tocoo()
    return csr_encode(coo_from_triplets(a.row, a.col, a.data, a.shape,
                                        device=device).pad(128))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_amg_apply_on_card_matches_cpu(card, smoother):
    """The V-cycle on the SELL kernels (every level's A, P and Pᵀ, vector
    and k = 4 block) against the same hierarchy's plain versions on the
    CPU; the rectangular P and Pᵀ plans run on the card."""
    from smvp_toolkit_tpu_torch.models.amg import amg_preconditioner

    counts = {}
    for dev in (card, torch.device("cpu")):
        m = amg_preconditioner(_poisson_csr(64, dev), smoother=smoother,
                               sweeps=2, op_builder=S.sell_op_csr)
        r = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4096, 4)).astype(np.float32)).to(dev)
        before = {k: f.launches for k, f in S.MAT_KERNELS.items()}
        counts[dev.type] = (m(r[:, 0]).cpu(), m(r).cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert any(f.launches > before[k]
                       for k, f in S.MAT_KERNELS.items())
    (zc, Zc), (zp, Zp) = counts["cuda"], counts["cpu"]
    assert _rel(zc, zp) <= 1e-5 and _rel(Zc, Zp) <= 1e-5
    assert _rel(Zc[:, 0], zc) <= 1e-5


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_amg_apply_on_split_planes_matches_cpu(card, smoother, monkeypatch):
    """The V-cycle with every level's A, P and Pᵀ (the rectangular ones
    too) on the split planes: K4 for the vector apply, K4 with k columns
    for the k = 4 block, against the same hierarchy's plain versions on
    the CPU. The planner keeps every level's window far under 512 tiles
    at a test size (it compacts each chunk's tiles), so the split route is
    taken through ``SMVP_SELL_RELSL=0``, the switch that puts every plan on
    the split planes; K4 must launch for both applies."""
    from smvp_toolkit_tpu_torch.models.amg import amg_preconditioner

    monkeypatch.setenv("SMVP_SELL_RELSL", "0")
    out = {}
    for dev in (card, torch.device("cpu")):
        m = amg_preconditioner(_poisson_csr(64, dev), smoother=smoother,
                               sweeps=2, op_builder=S.sell_op_csr)
        r = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4096, 4)).astype(np.float32)).to(dev)
        split0 = S.sell_split.launches
        mat0 = S.MAT_KERNELS["sell_split_spmm_kernel"].launches
        z = m(r[:, 0])
        split1 = S.sell_split.launches
        Z = m(r)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert split1 > split0
            assert S.MAT_KERNELS["sell_split_spmm_kernel"].launches > mat0
        out[dev.type] = (z.cpu(), Z.cpu())
    (zc, Zc), (zp, Zp) = out["cuda"], out["cpu"]
    assert _rel(zc, zp) <= 1e-5 and _rel(Zc, Zp) <= 1e-5
    assert _rel(Zc[:, 0], zc) <= 1e-5


def test_repeated_profile_sessions_record_the_kernel(card, tmp_path):
    """Five ``bench.profile`` sessions in one process each record all ten
    of K1's launches as device events (the CLI's ``-a --profile`` runs one
    session per format)."""
    import json

    from smvp_toolkit_tpu_torch.bench.profile import TRACE_FILE, profile_fn

    csr = _poisson_csr(64, card)
    x = torch.ones(csr.shape[1], device=card)
    for i in range(5):
        where = tmp_path / str(i)
        profile_fn(S.spmv_csr_sell, csr, x, log_dir=str(where))
        events = json.loads((where / TRACE_FILE).read_text())["traceEvents"]
        assert sum("sell_spmv_kernel" in e.get("name", "")
                   for e in events) == 10, i


def test_krylov_and_lobpcg_on_card_match_cpu(card):
    from smvp_toolkit_tpu_torch.models import solvers as M

    b = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    out = {}
    for dev in (card, torch.device("cpu")):
        csr = _poisson_csr(64, dev)
        bt = torch.from_numpy(b).to(dev)
        x1, _ = M.bicgstab(csr, bt, num_iters=8)
        x2, _ = M.gmres(csr, bt, restart=10, num_restarts=2)
        x3, _ = M.minres(csr, bt, num_iters=20)
        th, _, _ = M.lobpcg(csr, torch.eye(4096, 3, device=dev) + 0.1,
                            num_iters=10)
        out[dev.type] = [t.cpu() for t in (x1, x2, x3, th)]
    for c, p in zip(out["cuda"], out["cpu"]):
        assert _rel(c, p) <= 1e-4


@pytest.mark.parametrize("case", fuzz.CASES, ids=[c.name for c in fuzz.CASES])
def test_fuzz_case_kernels_match_plain_and_oracle(card, case):
    """The fuzz sweep (``utils/fuzz.py``) on the card: each rung launches
    its kernel and no other, within 1e-6 of max |y| of its plain version
    (the SpMM tolerance for k columns; K6 across two launches and K8
    against its plain version bit for bit) and within the JAX sweep's
    tolerance of the oracle."""
    rows, fails = fuzz.check_on_card(case, card)
    assert rows and not fails, fails


def test_coo_bridges_on_card(card):
    """``from_torch`` of a CUDA tensor coalesces on the card into the host
    path's triplets; ``to_torch`` lies on the card; ``sell_op_coo`` on the
    COO runs CSR's plan and K1."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode

    rng = np.random.default_rng(5)
    r = rng.integers(0, 3000, 40000)
    c = rng.integers(0, 2000, 40000)
    v = rng.standard_normal(40000)
    t = torch.sparse_coo_tensor(torch.from_numpy(np.stack([r, c])),
                                torch.from_numpy(v), (3000, 2000))
    host = COOMatrix.from_torch(t, pad_to=128, device="cpu")
    coo = COOMatrix.from_torch(t.to(card), pad_to=128)
    assert coo.device == card and coo.nnz == host.nnz < 40000
    for a, b in zip(coo.to_numpy(), host.to_numpy()):
        assert np.array_equal(a, b), "triplets differ"
    back = coo.to_torch()
    assert back.device == card and back.is_coalesced()
    op = S.sell_op_coo(coo)
    assert S.sell_op_coo(coo) is op and op.device == card
    csr_op = S.sell_op_csr(csr_encode(coo))
    for f in ("vals", "lidx", "relsl", "tile_base"):
        assert torch.equal(getattr(op, f), getattr(csr_op, f)), f
    x = torch.from_numpy(rng.standard_normal(2000).astype(np.float32)).to(
        card)
    before = S.sell_spmv.launches
    y = S.spmv_coo_sell(coo, x)
    assert S.sell_spmv.launches == before + 1
    assert _rel(y, csr_op(x)) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuned_operator_changes_route_and_matches_plain(card, dtype,
                                                         monkeypatch):
    """A power-law matrix (120,000 rows, hub columns) whose chunk-2048 plan
    takes the split planes (WT 688), which the shipped rates keep (no
    candidate is modelled 2% cheaper), and a cost that prices a plan by
    its tile window, under which the autotuned plan takes the merged word
    at a smaller chunk: the tuned operator (``from_coo`` on the card)
    launches K1 alone, within 1e-6 of max |y| of its plain version (the
    same plan on the CPU) and of the chunk-2048 operator's K4. The planes'
    route (``_route``, ``_apply``): a cost in tile windows is no cost the
    csr route's gate can set against K12's µs."""
    from smvp_toolkit_tpu_torch.ops import autotune as ta
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    monkeypatch.delenv("SMVP_SELL_AUTOTUNE", raising=False)
    coo = synth_powerlaw(120_000, 1_000_000, seed=0, device=card)
    pinned = S.SellSpMV.from_coo(coo, value_dtype=dtype)
    assert pinned._route() == "split" and pinned.plan.chunk == 2048
    monkeypatch.setattr(ta, "plan_cost_us",
                        lambda plan, *a: float(plan.window_tiles))
    op = S.SellSpMV.from_coo(coo, value_dtype=dtype)
    assert op._route() == "relsl" and op.plan.chunk < 2048
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        120_000).astype(np.float32)).to(card)
    before = (S.sell_spmv.launches, S.sell_split.launches)
    y, y_k4 = op._apply(x), pinned._apply(x)
    torch.cuda.synchronize()
    assert (S.sell_spmv.launches - before[0],
            S.sell_split.launches - before[1]) == (1, 1)
    plain = S.SellSpMV(op.plan, value_dtype=dtype, device="cpu")(x.cpu())
    assert _rel(y.cpu(), plain) <= TOL
    assert _rel(y, y_k4) <= TOL


@pytest.mark.parametrize("case", ["kron", "kron_dup", "hub", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_kernel_matches_plain_and_k1(card, dtype, case):
    """K12 (``csr_merge.csr_merge_spmv``) against its plain version on the
    same planes and against K1 on the same operator's plan, within
    ``spmm_tolerance`` of max |y| (max(1e-6, 2·2^-24·√n), n the most
    products a row sums, the hub case's hub row): the rows that a share's
    edge cuts take one atomicAdd a share in no fixed order, and K1 sums
    each row over its sublanes' atomics, so neither side's bits are the
    other's. Two launches count two."""
    import test_torch_csr_route as csr_cases
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.ops import csr_merge as M

    r, c, v, shape = csr_cases._case(case)
    coo = COOMatrix.from_numpy(np.asarray(r, np.int32),
                               np.asarray(c, np.int32), v, shape=shape,
                               device=card)
    op = S.SellSpMV.from_coo(coo, value_dtype=dtype, device=card)
    assert op.route == "relsl"  # at test size the gate keeps the planes
    planes = op.csr_planes()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        shape[1]).astype(np.float32)).to(card)
    xv = op._x_vector(x)
    before = M.csr_merge_spmv.launches
    y, y2 = M.csr_merge_spmv(planes, xv), M.csr_merge_spmv(planes, xv)
    torch.cuda.synchronize()
    assert M.csr_merge_spmv.launches == before + 2
    tol = spmm_tolerance(op.plan)[0]
    assert _rel(y, M.csr_merge_spmv_plain(planes, xv)) <= tol
    assert _rel(y, op._apply(x)) <= tol
    assert _rel(y2, y) <= tol


def test_csr_route_launches_k12_in_its_span(card, monkeypatch):
    """An operator the gate sends to the csr route (the shipped rates
    without their launch term, as the CPU tests set them): one call is
    one K12 launch inside one ``spmv.launch`` span, and no K1."""
    import test_torch_csr_route as csr_cases
    from smvp_toolkit_tpu_torch.ops import autotune as ta
    from smvp_toolkit_tpu_torch.ops import csr_merge as M
    from smvp_toolkit_tpu_torch.utils import tracing
    from smvp_toolkit_tpu_torch.utils.synth import synth_uniform

    rates = dict(ta.production_rates())
    rates["launch_us"] = 0.0
    monkeypatch.setattr(ta, "_PRODUCTION_RATES", rates)
    coo = synth_uniform(20000, 20000, 200000, seed=3, device=card)
    op = S.SellSpMV.from_coo(coo, device=card)
    assert op.route == "csr"
    x = torch.randn(coo.shape[1], device=card)
    op(x)
    before = (M.csr_merge_spmv.launches, S.sell_spmv.launches)
    tracing.enable()
    tracing.drain()
    try:
        y = op(x)
        names = [s.name for s in tracing.drain()["spans"]]
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    assert names == ["spmv.call", "spmv.launch"]
    assert (M.csr_merge_spmv.launches - before[0],
            S.sell_spmv.launches - before[1]) == (1, 0)
    assert _rel(y, op._apply(x)) <= TOL
    assert csr_cases._rel(y.cpu(), op._apply(x).cpu()) <= TOL
