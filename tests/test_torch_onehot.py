"""K6, the one-hot kernel, on the plan's own planes against the JAX package.

``SellPlan.oht_dense``/``seg_dense`` of both packages bit for bit; the
JAX launch's dense operands, as ``sell_onehot``'s plain version builds
them from the compact planes (``onehot_dense``, ``onehot_xw``), equal to
those views and to the JAX launch's stacking; the slice index the kernel
walks (``device_slice_index``, cached by ``SellSpMV.slice_index``) equal
to K8's ``slice_index`` and to the live part of K7's schedule order, and
to a numpy stable sort; ``sell_onehot``'s plain version (the CPU path)
against the JAX operator under ``SMVP_SELL_COMPAT=1`` (its K6 in Pallas
interpret mode), against K1's plain version and against K4's
(``sell_split_plain``) on the same planes, within 1e-6 of max |y|,
float32 and bfloat16, on small resident plans and on a plan with a hub
slice of over 2,000 live sublanes. A wrong ``rel`` or ``slice_of`` must
change y, and an index that misses a live sublane is refused.
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
HUB_ENTRIES = 2100
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _plan(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random":
        r, c = rng.randint(0, 3000, 20000), rng.randint(0, 4000, 20000)
        return jplan.build_sell_plan(r, c, rng.randn(20000), (3000, 4000),
                                     chunk=512)
    if name == "empty-rows":
        r = rng.randint(0, 1500, 9000) * 2
        c = np.clip(r + rng.randint(-200, 201, 9000), 0, 3499)
        return jplan.build_sell_plan(r, c, rng.randn(9000), (3100, 3500),
                                     chunk=256)
    if name == "int32-lidx":  # chunk not a multiple of 32
        r, c = rng.randint(0, 2000, 6000), rng.randint(0, 2000, 6000)
        return jplan.build_sell_plan(r, c, rng.randn(6000), (2000, 2000),
                                     chunk=200, allow_small_chunk=False)
    if name == "split-planes":  # WT > 511
        r, c = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
        return jplan.build_sell_plan(r, c, rng.randn(800), (3000, 70000),
                                     chunk=1024)
    if name == "hub-slice":  # one row of 2,100 products: a long slice
        r, c = rng.randint(0, 3000, 20000), rng.randint(0, 3000, 20000)
        r = np.concatenate([r, np.full(HUB_ENTRIES, 1000)])
        c = np.concatenate([c, rng.choice(3000, HUB_ENTRIES, replace=False)])
        return jplan.build_sell_plan(r, c, rng.randn(r.size), (3000, 3000),
                                     chunk=256)
    if name == "nnz0":
        e = np.zeros(0, np.int64)
        return jplan.build_sell_plan(e, e, np.zeros(0), (700, 500),
                                     chunk=256)
    raise AssertionError(name)


NAMES = ("random", "empty-rows", "int32-lidx", "split-planes", "hub-slice",
         "nnz0")


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    jp = _plan(request.param)
    x = np.random.default_rng(5).standard_normal(jp.shape[1]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def test_dense_views_bit_for_bit(case):
    _, jp, tp, _ = case
    for a, b in ((tp.oht_dense(), jp.oht_dense()),
                 (tp.seg_dense(), jp.seg_dense())):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_dense_views_refuse_streamed_plans():
    rng = np.random.RandomState(1)
    r, c = rng.randint(0, 5000, 3000), rng.randint(0, 900, 3000)
    jp = jplan.build_streamed_sell_plan(r, c, rng.randn(3000), (5000, 900),
                                        chunk=256, y_block_rows=2048)
    tp = plan_from_arrays(plan_fields(jp))
    for plan in (jp, tp):
        for view in (plan.oht_dense, plan.seg_dense):
            with pytest.raises(ValueError, match="streamed"):
                view()


def _operands(op, x):
    """K6's positional operands on ``op``'s planes and ``x``."""
    return (op.vals, op.lidx, *op.split_planes(), op.tile_base,
            op._x_tiles(x))


def test_operands_equal_the_views_and_the_jax_stacking(case):
    _, jp, tp, x = case
    op = tsp.SellSpMV(tp, device="cpu")
    nch, chunk, wt = tp.n_chunks, tp.chunk, tp.window_tiles
    oht, seg = tsp.onehot_dense(*op.split_planes(), n_slices=tp.n_slices,
                                chunk=chunk, window_tiles=wt)
    assert oht.shape == (nch, chunk, wt) and seg.shape == (
        nch, tp.n_slices, chunk)
    assert oht.dtype == seg.dtype == torch.float32
    assert np.array_equal(oht.reshape(-1, wt).numpy(), jp.oht_dense())
    assert np.array_equal(seg.permute(1, 0, 2).reshape(tp.n_slices, -1)
                          .numpy(), jp.seg_dense())
    assert op.slice_index() is op.slice_index()  # built once
    xt = op._x_tiles(torch.from_numpy(x))
    xw = tsp.onehot_xw(xt, op.tile_base, wt)
    tiles = xt.numpy().reshape(-1, 128)
    want = np.stack([tiles[b:b + wt] for b in tp.tile_base])
    assert xw.shape == (nch, wt, 128) and np.array_equal(xw.numpy(), want)


def test_slice_index_is_k8s_and_k7s_order(case):
    """The index K6 walks: K8's ``slice_index`` (one function, re-exported
    by ``spmv_df64``), the live prefix of K7's schedule order, and a numpy
    stable sort of the live sublanes by slice."""
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D

    name, _, tp, _ = case
    op = tsp.SellSpMV(tp, device="cpu")
    ptr, sub = op.slice_index()
    assert ptr.dtype == sub.dtype == torch.int32
    assert ptr.shape == (tp.n_slices + 1,)
    rel, sl = tp.rel_tile.reshape(-1), tp.slice_of.reshape(-1)
    live = np.flatnonzero((rel >= 0) & (sl >= 0))
    want = live[np.argsort(sl[live], kind="stable")]
    assert np.array_equal(sub.numpy(), want)
    assert np.array_equal(np.diff(ptr.numpy()),
                          np.bincount(sl[live], minlength=tp.n_slices))
    hptr, hsub = D.slice_index(tp)
    assert np.array_equal(hptr, ptr.numpy()) and np.array_equal(
        hsub, sub.numpy())
    order = op.vals_grad_schedule().order
    assert torch.equal(order[: sub.numel()], sub)
    if name == "hub-slice":
        assert int(np.diff(ptr.numpy()).max()) >= 2000


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tsp, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(tsp, name, spy)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_compat_call_matches_jax_k6(case, dtype, monkeypatch):
    name, jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setenv("SMVP_SELL_COMPAT", "1")
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    assert op.route == "onehot"
    calls = _spy(monkeypatch, "sell_onehot_plain")
    before = tsp.sell_onehot.launches
    y_t = op(torch.from_numpy(x))
    assert calls == ["sell_onehot_plain"]
    assert tsp.sell_onehot.launches == before
    y_j = jsp.SellSpMV(jp, value_dtype=jdt)(jnp.asarray(x))
    assert y_t.dtype == torch.float32 and y_t.shape == (tp.shape[0],)
    assert _rel(y_t.numpy(), y_j) <= TOL
    monkeypatch.delenv("SMVP_SELL_COMPAT")
    assert _rel(y_t.numpy(), op(torch.from_numpy(x)).numpy()) <= TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_split_plain(case, dtype):
    """The one-hot products and K4's gather and ``index_add_`` compute one
    function on the same split planes."""
    _, _, tp, x = case
    op = tsp.SellSpMV(tp, value_dtype=DTYPES[dtype][0], device="cpu")
    args = _operands(op, torch.from_numpy(x))
    y = tsp.sell_onehot_plain(*args, **op._onehot_kw())
    y4 = tsp.sell_split_plain(*args, n_slices=tp.n_slices, chunk=tp.chunk)
    assert y.shape == y4.shape == (tp.n_slices * 128,)
    assert _rel(y.numpy(), y4.numpy()) <= TOL


def test_wrong_dense_operands_change_y():
    """A wrong ``rel`` or ``slice_of`` (the planes the dense operands and
    the index are built from) changes y."""
    jp = _plan("random")
    tp = plan_from_arrays(plan_fields(jp))
    op = tsp.SellSpMV(tp, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tp.shape[1]).astype(np.float32))
    vals, lidx, rel, sl, tb, xt = _operands(op, x)
    kw = dict(n_slices=tp.n_slices, chunk=tp.chunk,
              window_tiles=tp.window_tiles)
    ref = tsp.sell_onehot(vals, lidx, rel, sl, tb, xt, **kw)
    assert _rel(ref[: tp.shape[0]].numpy(), op(x).numpy()) <= TOL
    s = int(np.nonzero(tp.slice_of.reshape(-1) >= 0)[0][5])
    bad_sl, bad_rel = sl.clone(), rel.clone()
    bad_sl[s] = (sl[s] + 1) % tp.n_slices
    bad_rel[s] = (rel[s] + 1) % tp.window_tiles
    for bad in (tsp.sell_onehot(vals, lidx, rel, bad_sl, tb, xt, **kw),
                tsp.sell_onehot(vals, lidx, bad_rel, sl, tb, xt, **kw)):
        assert _rel(bad.numpy(), ref.numpy()) > 1e-4


def test_onehot_argument_checks():
    tp = plan_from_arrays(plan_fields(_plan("random")))
    op = tsp.SellSpMV(tp, device="cpu")
    vals, lidx, rel, sl, tb, xt = _operands(op, torch.zeros(tp.shape[1]))
    ptr, sub = op.slice_index()
    dead = rel.clone()
    dead[int(sub[7])] = -1  # the index of planes with one sublane fewer
    missing = tsp.device_slice_index(dead, sl, tp.n_slices)
    good = dict(vals=vals, lidx=lidx, rel=rel, slice_of=sl, tile_base=tb,
                x=xt, n_slices=tp.n_slices, chunk=tp.chunk,
                window_tiles=tp.window_tiles, index=(ptr, sub))
    assert torch.equal(tsp.sell_onehot(**good),
                       tsp.sell_onehot(**{**good, "index": None}))
    for bad, err in ((dict(vals=vals.double()), TypeError),
                     (dict(lidx=lidx.to(torch.int16)), TypeError),
                     (dict(rel=rel.long()), TypeError),
                     (dict(x=xt.to(torch.bfloat16)), TypeError),
                     (dict(slice_of=sl[:-1]), ValueError),
                     (dict(x=xt[:-1]), ValueError),
                     (dict(vals=vals.t().contiguous().t()), ValueError),
                     (dict(window_tiles=0), ValueError),
                     (dict(index=(ptr.long(), sub)), ValueError),
                     (dict(index=(ptr[:-1], sub)), ValueError),
                     (dict(index=missing), ValueError)):
        with pytest.raises(err):
            tsp.sell_onehot(**{**good, **bad})


def test_streamed_plan_under_compat_keeps_its_kernels(monkeypatch):
    """The JAX compat kernel has no streamed-y form: a streamed plan
    leaves the merged word for the split planes (K3-split)."""
    rng = np.random.RandomState(2)
    r = rng.randint(0, 5000, 9000)
    c = np.clip(r + rng.randint(-64, 65, 9000), 0, 699)
    jp = jplan.build_streamed_sell_plan(r, c, rng.randn(9000), (5000, 700),
                                        chunk=256, y_block_rows=2048)
    tp = plan_from_arrays(plan_fields(jp))
    x = np.random.default_rng(1).standard_normal(700).astype(np.float32)
    monkeypatch.setenv("SMVP_SELL_COMPAT", "1")
    op = tsp.SellSpMV(tp, device="cpu")
    assert op.base_route == "streamy_relsl" and op.route == "streamy"
    calls = _spy(monkeypatch, "sell_streamy_plain")
    y_t = op(torch.from_numpy(x))
    assert calls == ["sell_streamy_plain"]
    y_j = jsp.SellSpMV(jp)(jnp.asarray(x))
    assert _rel(y_t.numpy(), y_j) <= TOL
