"""Every route of the port's SellSpMV against the JAX operator, plan by plan.

One plan per route (streamed y with the merged word, streamed y with split
planes, resident y with split planes because WT > 511), plus a streamed
plan with an empty middle y block and one with int32 lane indices. Both
packages run the same plan (``interop.plan_from_arrays``); the JAX
operator runs its Pallas kernels in interpret mode, as its own tests do;
the port runs on the CPU, where each wrapper takes its plain version.
``__call__`` and ``bench_loop`` in float32 and bfloat16 value modes:
max |Δ| / max |y| <= 1e-6 (the summation order differs, the gathers are
exact in both). Each case also checks that the route's own plain version
ran and that no kernel launch was counted.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL = 1e-6
BLOCK_ROWS = 2048
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# Per route: the forward and bench plain versions its wrappers must take.
PLAIN = {
    "relsl": ("sell_spmv_plain", "sell_bench_loop_plain"),
    "streamy_relsl": ("sell_streamy_relsl_plain",
                      "sell_bench_streamy_relsl_plain"),
    "streamy": ("sell_streamy_plain", "sell_bench_streamy_plain"),
    "split": ("sell_split_plain", "sell_bench_split_plain"),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _plan(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    stream = dict(y_block_rows=BLOCK_ROWS)
    if name == "streamed-relsl":
        n, nnz = 5000, 9000
        r = rng.randint(0, n, nnz)
        c = np.clip(r + rng.randint(-64, 65, nnz), 0, 699)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(nnz), (n, 700),
                                              chunk=256, **stream)
    if name == "streamed-split":  # WT > 511 in every block
        r, c = rng.randint(0, 4200, 1500), rng.randint(0, 70000, 1500)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(1500),
                                              (4200, 70000), chunk=1024,
                                              **stream)
    if name == "resident-split":  # one chunk over 547 column tiles
        r, c = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
        return jplan.build_sell_plan(r, c, rng.randn(800), (3000, 70000),
                                     chunk=1024)
    if name == "empty-middle-block":
        r = np.concatenate([rng.randint(0, BLOCK_ROWS, 2000),
                            rng.randint(2 * BLOCK_ROWS, 3 * BLOCK_ROWS,
                                        2000)])
        c = rng.randint(0, 900, 4000)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(4000),
                                              (3 * BLOCK_ROWS, 900),
                                              chunk=256, **stream)
    if name == "streamed-int32-lidx":  # chunk not a multiple of 32
        r, c = rng.randint(0, 4500, 6000), rng.randint(0, 2000, 6000)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(6000),
                                              (4500, 2000), chunk=208,
                                              **stream)
    raise AssertionError(name)


CASES = {
    "streamed-relsl": "streamy_relsl",
    "streamed-split": "streamy",
    "resident-split": "split",
    "empty-middle-block": "streamy_relsl",
    "streamed-int32-lidx": "streamy_relsl",
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jp = _plan(request.param)
    x = np.random.default_rng(5).standard_normal(jp.shape[1]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), x


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tsp, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(tsp, name, spy)
    return calls


def _launches():
    return [f.launches for pair in tsp._ROUTE_FNS.values() for f in pair]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_call_matches_jax_operator(case, dtype, monkeypatch):
    name, jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    assert op.route == CASES[name]
    calls = _spy(monkeypatch, PLAIN[op.route][0])
    before = _launches()
    y_t = op(torch.from_numpy(x))
    y_j = jsp.SellSpMV(jp, value_dtype=jdt)(jnp.asarray(x))
    assert calls == [PLAIN[op.route][0]]
    assert _launches() == before  # the CPU path launches nothing
    assert y_t.dtype == torch.float32 and y_t.shape == (tp.shape[0],)
    assert _rel(y_t.numpy(), y_j) <= TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bench_loop_matches_call_and_jax(case, dtype, monkeypatch):
    name, jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    xt = torch.from_numpy(x)
    y_call = op(xt)
    calls = _spy(monkeypatch, PLAIN[op.route][1])
    y_loop = op.bench_loop(xt, 3)
    assert calls == [PLAIN[op.route][1]]
    assert torch.equal(y_loop, y_call)  # bit for bit on the CPU
    y_j = jsp.SellSpMV(jp, value_dtype=jdt).bench_loop(jnp.asarray(x), 3)
    assert _rel(y_loop.numpy(), y_j) <= TOL


def test_planes_uploaded_per_route(case):
    name, _, tp, _ = case
    op = tsp.SellSpMV(tp, device="cpu")
    merged = op.route in ("relsl", "streamy_relsl")
    streamed = op.route.startswith("streamy")
    assert (op.relsl is not None) == merged
    assert (op.rel is not None) == (op.slice_of is not None) == (not merged)
    assert (op.y_block_id is not None) == streamed
    for t in (op.relsl, op.rel, op.slice_of, op.y_block_id, op.tile_base):
        assert t is None or (t.dtype == torch.int32 and t.dim() == 1)
    if not merged:
        assert op.rel.numel() == op.slice_of.numel() == tp.n_sublanes


def test_empty_middle_block_comes_back_zero():
    tp = plan_from_arrays(plan_fields(_plan("empty-middle-block")))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tp.shape[1]).astype(np.float32))
    op = tsp.SellSpMV(tp, device="cpu")
    for y in (op(x), op.bench_loop(x, 2)):
        assert not y[BLOCK_ROWS:2 * BLOCK_ROWS].any()
        assert y[:BLOCK_ROWS].abs().sum() > 0
        assert y[2 * BLOCK_ROWS:].abs().sum() > 0


def test_plain_matches_float64_oracle(case):
    import scipy.sparse as sp

    name, jp, tp, x = case
    # the plan's own entries: decode the planes on the host
    rel = tp.rel_tile.reshape(-1).astype(np.int64)
    sl = tp.slice_of.reshape(-1).astype(np.int64)
    live = np.nonzero((rel >= 0) & (sl >= 0))[0]
    c = live // tp.chunk
    base = (tp.y_block_id[c].astype(np.int64) * tp.y_block_slices
            if tp.y_block_slices else 0)
    rows = ((base + sl[live]) * 128)[:, None] + np.arange(128)
    cols = ((tp.tile_base[c].astype(np.int64) + rel[live]) * 128)[:, None] \
        + tp.lane_idx[live]
    v = tp.vals[live].astype(np.float64)
    keep = v != 0
    a = sp.csr_matrix((v[keep], (rows[keep], cols[keep])),
                      shape=(tp.n_slices * 128, tp.n_coltiles * 128))
    xp = np.zeros(tp.n_coltiles * 128)
    xp[: len(x)] = x
    ref = (a @ xp)[: tp.shape[0]]
    y = tsp.SellSpMV(tp, device="cpu")(torch.from_numpy(x))
    assert _rel(y.numpy(), ref) <= TOL
