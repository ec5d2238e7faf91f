"""K2-subwin and its windows against the JAX package.

``_sub_windows`` of both packages bit for bit (``stb``, ``ssb``,
``sub_wt``, ``sub_nsw``, and None on every ineligible plan); the
operator's ``bench_loop`` under ``SMVP_SELL_SUBWIN=1`` against the JAX
``bench_loop`` under the same environment (its subwin branch in Pallas
interpret mode) and against K2 relsl's plain version, within 1e-6 of max
|y|. ``SMVP_SELL_SPLIT_CHAIN`` sets the split, so chunks below 2048 get
sub-chains too. A wrong window must show: ``stb`` shifted by 16 tiles
misses the tolerance.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _plan(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "banded-256":
        n, nnz = 6000, 40000
        r = rng.randint(0, n, nnz)
        c = np.clip(r + rng.randint(-300, 301, nnz), 0, n - 1)
        return jplan.build_sell_plan(r, c, rng.randn(nnz), (n, n), chunk=256)
    if name == "banded-2048":  # the production split, 4
        n, nnz = 30000, 300000
        r = rng.randint(0, n, nnz)
        c = np.clip(r + rng.randint(-64, 65, nnz), 0, n - 1)
        return jplan.build_sell_plan(r, c, rng.randn(nnz), (n, n),
                                     chunk=2048)
    if name == "random-512":
        r, c = rng.randint(0, 3000, 30000), rng.randint(0, 5000, 30000)
        return jplan.build_sell_plan(r, c, rng.randn(30000), (3000, 5000),
                                     chunk=512)
    if name == "empty-rows-1024":
        r = rng.randint(0, 2000, 20000) * 3
        c = np.clip(r + rng.randint(-500, 501, 20000), 0, 6099)
        return jplan.build_sell_plan(r, c, rng.randn(20000), (6100, 6100),
                                     chunk=1024)
    raise AssertionError(name)


NAMES = ("banded-256", "banded-2048", "random-512", "empty-rows-1024")


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    jp = _plan(request.param)
    x = np.random.default_rng(6).standard_normal(jp.shape[1]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _same_windows(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for u, v in zip(a[:2], b[:2]):
        assert u.dtype == v.dtype == np.int32 and np.array_equal(u, v)
    assert a[2:] == b[2:]


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_sub_windows_bit_for_bit(case, split):
    _, jp, tp, _ = case
    _same_windows(tsp._sub_windows(tp, split), jsp._sub_windows(jp, split))


def test_sub_windows_none_on_ineligible_plans():
    rng = np.random.RandomState(3)
    e = np.zeros(0, np.int64)
    r, c = rng.randint(0, 5000, 3000), rng.randint(0, 900, 3000)
    wr, wc = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
    plans = [
        jplan.build_sell_plan(e, e, np.zeros(0), (700, 500), chunk=256),
        jplan.build_streamed_sell_plan(r, c, rng.randn(3000), (5000, 900),
                                       chunk=256, y_block_rows=2048),
        jplan.build_sell_plan(wr, wc, rng.randn(800), (3000, 70000),
                              chunk=1024),  # WT > 511: the guard
    ]
    live_out = _plan("random-512")  # a live sublane outside its window
    rel = live_out.rel_tile.copy()
    rel[np.nonzero(live_out.slice_of.reshape(-1) >= 0)[0][0]] = -1
    plans.append(dataclasses.replace(live_out, rel_tile=rel))
    for jp in plans:
        tp = plan_from_arrays(plan_fields(jp))
        for split in (2, 4):
            assert jsp._sub_windows(jp, split) is None
            assert tsp._sub_windows(tp, split) is None


def test_subwin_split_follows_the_jax_chain(monkeypatch):
    monkeypatch.delenv("SMVP_SELL_SPLIT_CHAIN", raising=False)
    assert [tsp.subwin_split(c) for c in (256, 1024, 2048, 2560, 4096)] == [
        1, 1, 4, 4, 4]
    monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
    assert [tsp.subwin_split(c) for c in (200, 256, 384, 512, 2048)] == [
        1, 2, 1, 2, 2]
    monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "1")
    assert tsp.subwin_split(2048) == 1


def _split_env(monkeypatch, plan):
    """SMVP_SELL_SUBWIN=1, with a chain split of 2 below chunk 2048."""
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    if plan.chunk < 2048:
        monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tsp, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(tsp, name, spy)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bench_loop_subwin_matches_jax(case, dtype, monkeypatch):
    name, jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    _split_env(monkeypatch, tp)
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    assert op.bench_route == "subwin" and op.route == "relsl"
    calls = _spy(monkeypatch, "sell_bench_subwin_plain")
    before = tsp.sell_bench_subwin.launches
    xt = torch.from_numpy(x)
    y_t = op.bench_loop(xt, 2)
    assert calls == ["sell_bench_subwin_plain"]
    assert tsp.sell_bench_subwin.launches == before
    y_j = jsp.SellSpMV(jp, value_dtype=jdt).bench_loop(jnp.asarray(x), 2)
    assert _rel(y_t.numpy(), y_j) <= TOL
    # against K2 relsl on the same plan
    y_k2 = tsp.sell_bench_loop_plain(*op._planes(), op._x_tiles(xt),
                                     iterations=1, **op._kw())
    assert _rel(y_t.numpy(), y_k2[: tp.shape[0]].numpy()) <= TOL


def test_shifted_windows_miss_the_tolerance(case, monkeypatch):
    _, _, tp, x = case
    _split_env(monkeypatch, tp)
    op = tsp.SellSpMV(tp, device="cpu")
    stb, ssb, split, sub_wt, sub_nsw = op.subwin_windows()
    xt = op._x_tiles(torch.from_numpy(x))
    kw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=1,
              **op._kw())
    planes = (op.vals, op.lidx, op.relsl, op.tile_base)
    good = tsp.sell_bench_subwin(*planes, stb, ssb, xt, **kw)
    ref = tsp.sell_spmv_plain(*planes, xt, **op._kw())
    assert _rel(good.numpy(), ref.numpy()) <= TOL
    for bad_stb, bad_ssb in ((stb + 16, ssb), (stb, ssb + 16)):
        bad = tsp.sell_bench_subwin(*planes, bad_stb, bad_ssb, xt, **kw)
        assert _rel(bad.numpy(), ref.numpy()) > TOL


def test_ineligible_bench_loops_keep_k2(monkeypatch):
    tp = plan_from_arrays(plan_fields(_plan("banded-256")))
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    assert tsp.SellSpMV(tp, device="cpu").bench_route == "relsl"  # split 1
    monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
    op = tsp.SellSpMV(tp, device="cpu")
    assert op.bench_route == "subwin"
    monkeypatch.setenv("SMVP_SELL_RELSL", "0")
    assert op.bench_route == "split"
    monkeypatch.delenv("SMVP_SELL_RELSL")
    monkeypatch.delenv("SMVP_SELL_SUBWIN")
    assert op.bench_route == "relsl"


def test_chunk_the_jax_chain_cannot_split_runs_k2(monkeypatch):
    """chunk 200 with SMVP_SELL_SPLIT_CHAIN=2: the JAX chain falls back to
    one chain (200 is not a multiple of 256) but its bench kernel has
    already dropped the x window for the sub-chain ones, and fails to
    trace. The port runs K2 relsl there, equal to the JAX bench_loop
    without the switch."""
    rng = np.random.RandomState(9)
    r, c = rng.randint(0, 2000, 6000), rng.randint(0, 2000, 6000)
    jp = jplan.build_sell_plan(r, c, rng.randn(6000), (2000, 2000),
                               chunk=200, allow_small_chunk=False)
    tp = plan_from_arrays(plan_fields(jp))
    x = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
    y_j = jsp.SellSpMV(jp).bench_loop(jnp.asarray(x), 2)
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    assert jsp._sub_windows(jp, 2) is not None
    with pytest.raises(TypeError):
        jsp.SellSpMV(jp).bench_loop(jnp.asarray(x), 2)
    op = tsp.SellSpMV(tp, device="cpu")
    assert op.bench_route == "relsl"
    y_t = op.bench_loop(torch.from_numpy(x), 2)
    assert _rel(y_t.numpy(), y_j) <= TOL


def test_subwin_argument_checks(monkeypatch):
    tp = plan_from_arrays(plan_fields(_plan("banded-256")))
    monkeypatch.setenv("SMVP_SELL_SUBWIN", "1")
    monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
    op = tsp.SellSpMV(tp, device="cpu")
    stb, ssb, split, sub_wt, sub_nsw = op.subwin_windows()
    xt = op._x_tiles(torch.zeros(tp.shape[1]))
    planes = (op.vals, op.lidx, op.relsl, op.tile_base)
    kw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=1,
              **op._kw())
    for bad in (dict(split=1), dict(split=3), dict(sub_wt=0),
                dict(iterations=0)):
        with pytest.raises(ValueError):
            tsp.sell_bench_subwin(*planes, stb, ssb, xt, **{**kw, **bad})
    for s_bad, b_bad in ((stb.long(), ssb), (stb, ssb[:, :1].contiguous()),
                         (stb.t().contiguous(), ssb)):
        with pytest.raises(ValueError):
            tsp.sell_bench_subwin(*planes, s_bad, b_bad, xt, **kw)
