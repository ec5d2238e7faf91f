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

from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    build_sell_plan,
    build_streamed_sell_plan,
)

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


def test_cli_tjds_path_launches_kernels(card):
    from smvp_toolkit_tpu_torch.cli import main

    S.sell_spmv.launches = S.sell_bench_loop.launches = 0
    assert main(["-t", "--decode-check", "-n", "5", "--no-report",
                 "synth:20000:200000"]) == 0
    assert S.sell_spmv.launches >= 5 and S.sell_bench_loop.launches == 0
