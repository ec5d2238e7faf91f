"""The csr route (``ops/csr_merge.py``, K12) on the CPU.

K12's merge coordinates against a walk of the merged path; its plain
version against a float64 oracle and against K1's plain version on the
same operator; the kernel's walk (``csrc/csr_spmv.cu``: the vector loads,
the lanes' merge-path search and walk, the segmented scan of the carries,
the stores and the atomics), emulated warp by warp in numpy, against the
plain version, with every row written by one store or by atomics alone;
the operator's gate at the card's cost model (``autotune.takes_csr``),
the switches that keep the planes, and the route's spans and counter.
The matrices: a small permuted Kronecker graph (empty rows, hub rows over
several shares), with duplicate triplets in storage order, a hub row of
several warps' shares, and rows of every length up to three shares (a
share's edge at every offset of a row). The card test is
``tests/test_torch_cuda.py::test_csr_kernel_matches_plain_and_k1``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.ops import autotune as ta
from smvp_toolkit_tpu_torch.ops import csr_merge as M
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan
from smvp_toolkit_tpu_torch.utils import tracing
from smvp_toolkit_tpu_torch.utils.synth import (
    hpcg_stencil,
    synth_banded,
    synth_powerlaw,
    synth_uniform,
)

TOL = 1e-6  # float32 sums in another order than the float64 oracle's


def _kron(scale: int = 11, seed: int = 0):
    """A Graph500 Kronecker graph (A 0.57, B = C 0.19, edge factor 16),
    ids permuted, undirected, no self loops or duplicates, values 1/degree
    of the column."""
    rng = np.random.default_rng(seed)
    n, m = 1 << scale, 16 << scale
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m) > 0.76
        jj = rng.random(m) > np.where(ii, 0.19 / 0.24, 0.57 / 0.76)
        u += ii.astype(np.int64) << bit
        v += jj.astype(np.int64) << bit
    perm = rng.permutation(n)
    u, v = perm[u], perm[v]
    keep = u != v
    keys = np.unique(np.concatenate([u[keep] * n + v[keep],
                                     v[keep] * n + u[keep]]))
    rows, cols = keys // n, keys % n
    deg = np.bincount(rows, minlength=n)
    return rows, cols, (1.0 / deg[cols]).astype(np.float32), (n, n)


def _case(name: str):
    rng = np.random.default_rng(len(name))
    if name == "kron":
        return _kron()
    if name == "kron_dup":  # a tenth of the triplets again, out of order
        r, c, v, shape = _kron(seed=1)
        extra = rng.choice(len(r), len(r) // 10, replace=False)
        order = rng.permutation(len(r) + len(extra))
        return (np.concatenate([r, r[extra]])[order],
                np.concatenate([c, c[extra]])[order],
                np.concatenate([v, v[extra] * 3])[order], shape)
    if name == "hub":  # one row of several shares among short and empty ones
        n = 700
        r = np.concatenate([np.full(5 * M.WARP_PATH + 7, 351),
                            rng.integers(0, n // 2, 900) * 2])
        c = rng.integers(0, 3000, len(r))
        return r, c, rng.standard_normal(len(r)), (n, 3000)
    if name == "edges":  # row i holds i nonzeros, up to three shares
        lens = np.arange(3 * M.WARP_PATH + 4)
        r = np.repeat(np.arange(len(lens)), lens)
        c = rng.integers(0, 500, len(r))
        return r, c, rng.standard_normal(len(r)), (len(lens), 500)
    if name == "empty":
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
                (300, 40))
    raise KeyError(name)


CASES = ["kron", "kron_dup", "hub", "edges", "empty"]
DTYPES = [torch.float32, torch.bfloat16]


def _oracle(planes: M.CsrPlanes, x: torch.Tensor) -> np.ndarray:
    """y in float64 from the planes' (rounded) values and x."""
    nnz = planes.nnz
    rows = np.repeat(np.arange(planes.shape[0]),
                     np.diff(planes.row_ptr.numpy()))
    y = np.zeros(planes.shape[0])
    np.add.at(y, rows, planes.vals[:nnz].double().numpy()
              * x.double().numpy()[planes.cols[:nnz].numpy()])
    return y


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    gap = np.abs(a - b).max() if b.size else 0.0
    return float(gap / scale) if scale else float(gap)


def _planes(name, dtype=torch.float32):
    r, c, v, shape = _case(name)
    return M.csr_planes(r, c, v, shape, dtype, "cpu")


def _x(planes, dtype=torch.float32, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(planes.shape[1], generator=g).to(dtype)


# -- the merge coordinates ---------------------------------------------------


def _walk(row_ptr: np.ndarray, nnz: int, warp_path: int):
    """The merged path walked item by item (a row's end after its last
    nonzero), its (row, nonzero) at every multiple of ``warp_path`` and at
    its end."""
    nrows = len(row_ptr) - 1
    total, out, x, y = nrows + nnz, [], 0, 0
    for d in range(total + 1):
        if d % warp_path == 0 or d == total:
            out.append((x, y))
        if d < total:
            if x < nrows and row_ptr[x + 1] <= y:
                x += 1
            else:
                y += 1
    return out


@pytest.mark.parametrize("warp_path", [4, 32, M.WARP_PATH])
@pytest.mark.parametrize("name", CASES)
def test_merge_coords_are_the_merge_walk(name, warp_path):
    planes = _planes(name)
    got = M.merge_coords(planes.row_ptr, planes.nnz, warp_path)
    want = _walk(planes.row_ptr.numpy(), planes.nnz, warp_path)
    assert [tuple(p) for p in got.tolist()] == want
    assert got.dtype == torch.int32
    shares = np.diff(got.numpy().sum(axis=1))
    assert (shares[:-1] == warp_path).all() and 0 < shares[-1] <= warp_path


def test_planes_sort_by_row_and_keep_duplicates():
    r, c, v, shape = _case("kron_dup")
    planes = M.csr_planes(r, c, v, shape, torch.float32, "cpu")
    assert planes.nnz == len(r)
    assert planes.cols.numel() % 4 == 0 and planes.vals.numel() % 4 == 0
    assert not planes.cols[planes.nnz:].any()
    assert not planes.vals[planes.nnz:].any()
    rp = planes.row_ptr.numpy()
    assert rp[0] == 0 and rp[-1] == len(r) and (np.diff(rp) >= 0).all()
    assert (np.diff(rp) == np.bincount(r, minlength=shape[0])).all()
    order = np.argsort(r, kind="stable")  # stable: storage order in a row
    assert (planes.cols[: planes.nnz].numpy() == c[order]).all()
    assert (planes.vals[: planes.nnz].numpy()
            == v[order].astype(np.float32)).all()


# -- the plain version --------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_oracle_and_k1(name, dtype):
    """K12's plain version against the float64 product of the rounded
    values and x, and against K1's plain version (``_apply``) on the same
    operator's plan."""
    r, c, v, shape = _case(name)
    coo = COOMatrix.from_numpy(np.asarray(r, np.int32),
                               np.asarray(c, np.int32), v, shape=shape,
                               device="cpu")
    op = S.SellSpMV.from_coo(coo, value_dtype=dtype, device="cpu")
    planes = op.csr_planes()
    x = _x(planes)
    xv = op._x_vector(x)
    y = M.csr_merge_spmv_plain(planes, xv)
    assert y.dtype == torch.float32 and y.shape == (shape[0],)
    assert _rel(y, _oracle(planes, xv)) <= TOL
    assert _rel(y, op._apply(x)) <= TOL


# -- the kernel's walk, emulated ---------------------------------------------


def _emulate_k12(planes: M.CsrPlanes, x: torch.Tensor, items: int = M.ITEMS):
    """``csrc/csr_spmv.cu``'s warps in numpy, step for step in float32:
    returns y and, per row, the stores and the atomics it took."""
    wp = 32 * items
    loads = (wp + 3 + 127) // 128
    nrows, nnz = planes.shape[0], planes.nnz
    pad = planes.cols.numel()
    rp = planes.row_ptr.numpy().astype(np.int64)
    co = planes.coords.numpy().astype(np.int64)
    cols = planes.cols.numpy()
    vals = planes.vals.float().numpy()
    xf = x.float().numpy()
    y = np.zeros(nrows, np.float32)
    stores = np.zeros(nrows, np.int64)
    atomics = np.zeros(nrows, np.int64)

    def store(row, val):
        assert stores[row] == 0 and atomics[row] == 0, row
        stores[row] += 1
        y[row] = val

    def atomic(row, val):
        assert stores[row] == 0, row
        atomics[row] += 1
        y[row] = np.float32(y[row] + val)

    for w in range(len(co) - 1):
        (row0, y0), (row1, y1) = co[w], co[w + 1]
        nr, nn = row1 - row0, y1 - y0
        assert 0 < nr + nn <= wp
        # 1. the vector loads of four from the aligned word below y0
        prod = np.full(nn, np.nan, np.float32)
        for lane in range(32):
            for u in range(loads):
                i = (y0 & ~3) + 4 * lane + 128 * u
                if i < y1:
                    assert i % 4 == 0 and i + 4 <= pad
                    for k in range(4):
                        j = i + k - y0
                        if 0 <= j < nn:
                            prod[j] = np.float32(vals[i + k]
                                                 * xf[cols[i + k]])
        assert not np.isnan(prod).any()  # every nonzero loaded
        # 2. the rows' ends in the share's coordinates
        ends = rp[row0 + 1: row0 + 1 + nr] - y0
        # 3. each lane's search and walk
        lanes = []
        for lane in range(32):
            d = min(lane * items, nr + nn)
            lo, hi = max(0, d - nn), min(d, nr)
            while lo < hi:
                mid = (lo + hi) // 2
                if ends[mid] + mid < d:
                    lo = mid + 1
                else:
                    hi = mid
            tx, ty = lo, d - lo
            run, head, head_row = np.float32(0), np.float32(0), -1
            for _ in range(min(items, nr + nn - d)):
                if tx < nr and ends[tx] <= ty:
                    if head_row < 0:
                        head, head_row = run, tx
                    else:
                        store(row0 + tx, run)
                    run = np.float32(0)
                    tx += 1
                else:
                    run = np.float32(run + prod[ty])
                    ty += 1
            lanes.append((run, head_row >= 0, head, head_row))
        # 4. the segmented inclusive scan of the carries (shuffles up)
        carry = [ln[0] for ln in lanes]
        flag = [int(ln[1]) for ln in lanes]
        off = 1
        while off < 32:
            c2, f2 = list(carry), list(flag)
            for lane in range(off, 32):
                if not flag[lane]:
                    c2[lane] = np.float32(carry[lane] + carry[lane - off])
                f2[lane] = flag[lane] | flag[lane - off]
            carry, flag = c2, f2
            off *= 2
        for lane, (_run, has, head, head_row) in enumerate(lanes):
            if has:
                total = np.float32(head + (carry[lane - 1] if lane else 0))
                if head_row == 0 and rp[row0] < y0:
                    atomic(row0, total)
                else:
                    store(row0 + head_row, total)
        # 5. the row the next warp ends
        if y1 > rp[row1]:
            atomic(row1, carry[31])
    return y, stores, atomics


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_matches_plain(name, dtype):
    planes = _planes(name, dtype)
    x = _x(planes, dtype)
    y, stores, atomics = _emulate_k12(planes, x)
    assert ((stores == 1) | ((stores == 0) & (atomics >= 1))).all()
    rp = planes.row_ptr.numpy()
    # a row that is cut by a share's edge takes atomics, one a share
    cut = atomics > 0
    assert (np.diff(rp)[cut] > 0).all()
    assert _rel(y, M.csr_merge_spmv_plain(planes, x)) <= TOL
    assert _rel(y, _oracle(planes, x)) <= TOL


@pytest.mark.parametrize("items", [1, 4, 16])
def test_kernel_walk_other_share_sizes(items):
    """The walk at other items a lane than the kernel's ``kItems`` over
    coordinates cut at 32 times it (``merge_coords``' share argument)."""
    planes = _planes("edges")
    planes = M.CsrPlanes(planes.row_ptr, planes.cols, planes.vals,
                         M.merge_coords(planes.row_ptr, planes.nnz,
                                        32 * items),
                         planes.nnz, planes.shape)
    x = _x(planes)
    y, stores, atomics = _emulate_k12(planes, x, items)
    assert ((stores == 1) | ((stores == 0) & (atomics >= 1))).all()
    assert _rel(y, _oracle(planes, x)) <= TOL


# -- the operator's gate ------------------------------------------------------


@pytest.fixture
def no_launch_term(monkeypatch):
    """The shipped rates without their launch term: at test sizes the
    launch (9.14 µs on both sides) hides what the bytes of a plan cost."""
    rates = dict(ta.production_rates())
    rates["launch_us"] = 0.0
    monkeypatch.setattr(ta, "_PRODUCTION_RATES", rates)
    for var in ("SMVP_SELL_PACK", "SMVP_SELL_COMPAT", "SMVP_SELL_SPLIT",
                "SMVP_SELL_RELSL", "SMVP_SELL_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    return rates


def _coo(name):
    r, c, v, shape = _case(name)
    return COOMatrix.from_numpy(np.asarray(r, np.int32),
                                np.asarray(c, np.int32), v, shape=shape,
                                device="cpu")


def _scattered():
    return synth_uniform(20000, 20000, 200000, seed=3, device="cpu")


def _hpcg_like():
    return COOMatrix.from_scipy(hpcg_stencil(16).tocoo(), device="cpu")


def test_scattered_matrix_takes_csr(no_launch_term):
    coo = _scattered()
    op = S.SellSpMV.from_coo(coo, device="cpu")
    plan_us = ta.pick_plan(*coo.to_numpy(), coo.shape,
                           rates=no_launch_term)[1]
    assert op._plan_cost_us == pytest.approx(plan_us, rel=1e-12)
    assert ta.takes_csr(op.plan, coo.nnz, 4, plan_us) and op.route == "csr"
    x = torch.randn(coo.shape[1])
    assert _rel(op(x), op._apply(x)) <= TOL
    r, c, v = coo.to_numpy()
    y64 = np.zeros(coo.shape[0])
    np.add.at(y64, r, v.astype(np.float64) * x.double().numpy()[c])
    assert _rel(op(x), y64) <= TOL


@pytest.mark.parametrize("maker", [_hpcg_like, lambda: synth_banded(
    20000, seed=1, device="cpu")])
def test_full_plans_keep_relsl(no_launch_term, maker):
    """HPCG's 27-point stencil and a band fill their plans: K12 is not
    modelled twice as cheap."""
    op = S.SellSpMV.from_coo(maker(), device="cpu")
    assert op.route == "relsl" and not op.csr_on()


@pytest.mark.parametrize("maker", [
    _scattered, _hpcg_like,
    lambda: synth_powerlaw(30000, 300000, seed=2, device="cpu"),
    lambda: _coo("kron")])
def test_test_sized_matrices_keep_their_route(maker, monkeypatch):
    """At the shipped rates the launch term keeps every test-sized plan
    on its planes, the scattered ones too."""
    for var in ("SMVP_SELL_PACK", "SMVP_SELL_COMPAT", "SMVP_SELL_SPLIT",
                "SMVP_SELL_RELSL"):
        monkeypatch.delenv(var, raising=False)
    coo = maker()
    op = S.SellSpMV.from_coo(coo, device="cpu")
    assert op.route == op.base_route != "csr"
    cached = S.sell_op_coo(coo)
    assert cached.route != "csr"


@pytest.mark.parametrize("env, value, dtype, route", [
    ("SMVP_SELL_PACK", "1", torch.bfloat16, "packed"),
    ("SMVP_SELL_COMPAT", "1", torch.float32, "onehot"),
    ("SMVP_SELL_SPLIT", "2", torch.float32, "relsl"),
    ("SMVP_SELL_RELSL", "0", torch.float32, "split"),
])
def test_each_switch_keeps_its_route(no_launch_term, monkeypatch, env, value,
                                     dtype, route):
    coo = _scattered()
    op = S.SellSpMV.from_coo(coo, value_dtype=dtype, device="cpu")
    assert op.route == "csr"
    x = torch.randn(coo.shape[1])
    y_csr = op(x)
    monkeypatch.setenv(env, value)
    assert op.route == route and not op.csr_on()
    tracing.enable()
    tracing.drain()
    try:
        y = op(x)
        names = {s.name for s in tracing.drain()["spans"]}
    finally:
        tracing.disable()
    assert "spmv.x_tiles" in names  # the planes' path
    assert _rel(y, y_csr) <= TOL


def test_csr_needs_triplets_and_is_priced_where_not_tuned(no_launch_term):
    """An operator from a bare plan keeps its planes; ``transpose`` (not
    priced by the autotuner) prices its plan at the first call."""
    coo = _scattered()
    r, c, v = coo.to_numpy()
    bare = S.SellSpMV(build_sell_plan(r, c, v, coo.shape), device="cpu")
    assert bare.route == "relsl"
    op = S.SellSpMV.from_coo(coo, device="cpu")
    t = op.transpose()
    assert t._plan_cost_us is None and t.route == "csr"
    g = torch.randn(coo.shape[0])
    y64 = np.zeros(coo.shape[1])
    np.add.at(y64, c, v.astype(np.float64) * g.double().numpy()[r])
    assert _rel(t(g), y64) <= TOL


def test_cached_operators_take_csr(no_launch_term):
    coo = _scattered()
    op = S.sell_op_coo(coo)
    assert op.route == "csr" and op._plan_cost_us is not None
    x = torch.randn(coo.shape[1])
    assert _rel(S.spmv_coo_sell(coo, x), op._apply(x)) <= TOL


def test_matmat_bench_loop_and_vals_keep_the_planes(no_launch_term):
    coo = _scattered()
    op = S.SellSpMV.from_coo(coo, device="cpu")
    x = torch.randn(coo.shape[1])
    y = op(x)
    tracing.enable()
    tracing.drain()
    try:
        y1 = op.matmat(x[:, None])[:, 0]
        y2 = op.bench_loop(x, 2)
        y3 = op._apply(x, op.vals.reshape(-1).clone())
        names = [s.name for s in tracing.drain()["spans"]]
    finally:
        tracing.disable()
    assert names.count("spmv.x_tiles") == 3
    for other in (y1, y2, y3):
        assert _rel(other, y) <= TOL


def test_fuzz_rungs_name_k12_only_for_the_call(no_launch_term):
    """The fuzz sweep's kernel of each rung on a csr operator: K12 for a
    call, the plane kernels for ``matmat``, ``bench_loop`` and the values
    gradient; a case's routes are compared as names."""
    from smvp_toolkit_tpu_torch.utils import fuzz

    coo = _scattered()
    op = S.SellSpMV.from_coo(coo, device="cpu")
    assert op.route == "csr" and op._route() == "relsl"
    assert fuzz.rung_kernel(op, "spmv") == "csr_merge_spmv_kernel"
    plane = S.KERNEL_NAMES[("relsl", False)]
    assert fuzz.rung_kernel(op, "matmat k=1") == plane
    assert fuzz.rung_kernel(op, "matmat k=4") == "sell_spmm_kernel"
    assert fuzz.rung_kernel(op, "bench_loop(3)") == \
        S.KERNEL_NAMES[("relsl", True)]
    assert fuzz.rung_kernel(op, "vjp_vals_mat") == "sell_vals_grad_kernel"
    case = fuzz.FuzzCase(name="scattered", seed=0, n=coo.shape[0],
                         m=coo.shape[1], nnz=coo.nnz, k=1, dtype="f32",
                         env={}, route="csr")
    assert fuzz.route_mismatch(case, op) is None
    kept = dataclasses.replace(case, route="relsl")
    assert "routes csr/relsl" in fuzz.route_mismatch(kept, op)


def test_csr_call_spans_and_counter(no_launch_term):
    """A csr call is one ``spmv.launch`` inside ``spmv.call`` and no x
    tiles; on the CPU the plain version runs and the counter stays."""
    assert tracing.kernel_wrappers()["csr_merge_spmv_kernel"] is \
        M.csr_merge_spmv
    coo = _scattered()
    op = S.SellSpMV.from_coo(coo, device="cpu")
    x = torch.randn(coo.shape[1])
    op(x)  # builds the planes
    before = M.csr_merge_spmv.launches
    tracing.enable()
    tracing.drain()
    try:
        for _ in range(3):
            op(x)
        got = tracing.drain()
    finally:
        tracing.disable()
    names = [s.name for s in got["spans"]]
    assert names == ["spmv.call", "spmv.launch"] * 3
    by_id = {s.id: s for s in got["spans"]}
    assert all(by_id[s.parent].name == "spmv.call"
               for s in got["spans"] if s.name == "spmv.launch")
    assert M.csr_merge_spmv.launches == before
    assert "csr_merge_spmv_kernel" not in got["counters"]


def test_x_in_place_and_short_x():
    planes = _planes("hub")
    op_x = _x(planes)
    y = M.csr_merge_spmv(planes, op_x)
    assert _rel(y, _oracle(planes, op_x)) <= TOL
    r, c, v, shape = _case("hub")
    coo = COOMatrix.from_numpy(r.astype(np.int32), c.astype(np.int32), v,
                               shape=shape, device="cpu")
    op = S.SellSpMV.from_coo(coo, device="cpu")
    x = torch.randn(shape[1])
    # float32 and contiguous: read in place, no copy
    assert op._x_vector(x).data_ptr() == x.data_ptr()
    short = x[:1000]
    assert _rel(M.csr_merge_spmv(op.csr_planes(), op._x_vector(short)),
                op._apply(short)) <= TOL
    with pytest.raises(ValueError, match="entries"):
        op._x_vector(torch.zeros(op.plan.n_coltiles * 128 + 1))


def test_wrapper_refusals():
    planes = _planes("kron")
    x = _x(planes)
    with pytest.raises(ValueError, match="torch.float32"):
        M.csr_merge_spmv(planes, x.double())
    with pytest.raises(ValueError, match="at least"):
        M.csr_merge_spmv(planes, x[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        M.csr_merge_spmv(planes, torch.stack([x, x], 1)[:, 0])


# -- the cost model of the route ----------------------------------------------


def test_csr_bytes_and_cost():
    assert ta.csr_bytes(10, 3, 5, 4) == 80 + 16 + 20 + 12
    assert ta.csr_bytes(10, 3, 5, 2) == 60 + 16 + 10 + 12
    rates = ta.production_rates()
    nb = ta.csr_bytes(31_401_836, 1 << 20, 1 << 20, 4)
    assert ta.csr_cost_us(31_401_836, 1 << 20, 1 << 20, 4, rates) == \
        pytest.approx(nb / (rates["gb_s_f32"] * 1e3) + rates["launch_us"])
    nb16 = ta.csr_bytes(100, 10, 10, 2)
    assert ta.csr_cost_us(100, 10, 10, 2, rates) == pytest.approx(
        nb16 / (rates["gb_s_bf16"] * 1e3) + rates["launch_us"])


def test_gate_factor_and_the_launch_floor():
    plan = build_sell_plan(np.arange(3), np.arange(3), np.ones(3), (3, 3))
    rates = ta.production_rates()
    csr_us = ta.csr_cost_us(3, 3, 3, 4, rates)
    assert ta.takes_csr(plan, 3, 4, ta.CSR_GAIN * csr_us)
    assert not ta.takes_csr(plan, 3, 4, ta.CSR_GAIN * csr_us * 0.999)
    # the plan's own cost where none is given: this one is small
    assert not ta.takes_csr(plan, 3, 4)
    # A plan under one launch's worth of bytes never switches, however few
    # bytes K12 would move (about 26 MB of planes at the shipped rates).
    floor = rates["launch_us"] * rates["gb_s_f32"] * 1e3
    assert 25e6 < floor < 27e6
    plan_us = (0.99 * floor) / (rates["gb_s_f32"] * 1e3) + rates["launch_us"]
    assert not ta.takes_csr(plan, 1, 4, plan_us)


def test_tuned_plan_returns_the_picks_cost(monkeypatch):
    monkeypatch.delenv("SMVP_SELL_AUTOTUNE", raising=False)
    r, c, v = _scattered().to_numpy()
    plan, cost = ta.tuned_plan(r, c, v, (20000, 20000), bf16=False)
    pick, pick_cost = ta.pick_plan(r, c, v, (20000, 20000),
                                   rates=ta.production_rates())
    assert plan.chunk == pick.chunk and cost == pytest.approx(pick_cost)
    assert ta._tuned_plan(r, c, v, (20000, 20000), bf16=False)[1] is None
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    assert ta.tuned_plan(r, c, v, (20000, 20000), bf16=False)[1] is None
