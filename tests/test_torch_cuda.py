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


# -- the k-column kernels: K1/K4 with k > 1, K2 with k > 1, K7 -------------


def _block(card, rows, k, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, k)).astype(np.float32)).to(card).to(dtype).contiguous()


@pytest.mark.parametrize("k", [1, 2, 8, 17, 40])
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


def test_cli_spmm_launches_kcolumn_kernels(card, tmp_path):
    from smvp_toolkit_tpu_torch.cli import main

    spec = "synth:20000:200000"
    for fused, want in ((False, "sell_spmm_kernel"),
                        (True, "sell_bench_spmm_kernel")):
        for fn in S.MAT_KERNELS.values():
            fn.launches = 0
        out = str(tmp_path / f"y{int(fused)}.npy")
        argv = ["-c", "-n", "3", "--no-report", "--spmm", "4",
                "--spmm-out", out] + (["--fused"] if fused else [])
        assert main(argv + [spec]) == 0
        counts = {n: f.launches for n, f in S.MAT_KERNELS.items()}
        assert counts.pop(want) >= 3 and not any(counts.values())
        assert np.load(out).shape == (20000, 4)


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
