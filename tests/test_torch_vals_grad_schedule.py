"""K7's by-slice schedule and walk against the JAX package.

The values-gradient kernel (``csrc/sell_vals_grad.cu``) walks the plan by
slice: ``vals_grad_schedule`` lists the live sublanes grouped by slice (plan
order within a slice), cut into units of at most ``VG_CAP`` sublanes (the
kernel holds ``VG_RUN``), then the dead ones. The index must equal a numpy
regrouping of the plan's live sublanes, be the same from the merged word
and from the split planes, and cover every sublane once. ``_walk`` below is the kernel's walk in numpy,
summed in its order (a lane whose index is not 0: eight partials, each
thread's columns of every column block of 8·W in order, added by the
kernel's butterfly; a lane of index 0: against its tile's first X row,
column blocks in order, the 8·W products of a block in order);
on the small plans and the hub-row plan (a slice of 200 sublanes, cut
into several units), at k = 1, 2, 8, 17 and 256, X in float32 and
bfloat16, on both routes, it must equal the plain version and the JAX
``vjp_vals_mat`` (Pallas interpret mode) within 1e-6 of max |plane|, with
dead sublanes exactly 0 and padding lanes carrying their partials.
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

import test_torch_autograd as autograd
import torch_kcol_plans as kcol

TOL_PLANE = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PLANS = ("small-relsl", "small-split", "hub-relsl", "hub-split")


def _jax_plan(name):
    kind, route = name.split("-")
    if kind == "small":
        return autograd._plan_pair(route)[0]
    r, c, v, shape, chunk = kcol.hub_row_triplets(route)
    return jplan.build_sell_plan(r, c, v, shape, chunk=chunk)


@pytest.fixture(scope="module", params=PLANS)
def case(request):
    jp = _jax_plan(request.param)
    return request.param, jp, plan_from_arrays(plan_fields(jp))


def _numpy_schedule(plan, cap):
    """The schedule by numpy alone: (order, unit_start, unit_slice)."""
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    live = np.flatnonzero((rel >= 0) & (sl >= 0))
    dead = np.flatnonzero((rel < 0) | (sl < 0))
    order, starts, slices = [], [], []
    for s in np.unique(sl[live]):
        ids = live[sl[live] == s]  # plan order within the slice
        for i in range(0, ids.size, cap):
            starts.append(len(order))
            slices.append(s)
            order += ids[i:i + cap].tolist()
    for i in range(0, dead.size, cap):
        starts.append(len(order) + i)
        slices.append(-1)
    order += dead.tolist()
    return (np.asarray(order, np.int64), np.asarray(starts + [len(order)]),
            np.asarray(slices, np.int64))


@pytest.mark.parametrize("cap", [tsp.VG_RUN, tsp.VG_CAP, 16, 1])
def test_schedule_is_the_numpy_regrouping(case, cap):
    _, _, tp = case
    op = tsp.SellSpMV(tp, device="cpu")
    rel, sl = (tsp._decode_word(op.relsl) if op.relsl is not None
               else op.split_planes())
    sched = tsp.vals_grad_schedule(rel, sl, cap=cap)
    order, starts, slices = _numpy_schedule(tp, cap)
    for t in (sched.order, sched.unit_start, sched.unit_slice):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert np.array_equal(sched.order.numpy(), order)
    assert np.array_equal(sched.unit_start.numpy(), starts)
    assert np.array_equal(sched.unit_slice.numpy(), slices)
    # every sublane once; a unit holds 1..cap sublanes of its one slice
    assert np.array_equal(np.sort(order), np.arange(tp.n_sublanes))
    size = np.diff(starts)
    assert size.min() >= 1 and size.max() <= cap
    sl_np = tp.slice_of.reshape(-1)
    for u in np.flatnonzero(slices >= 0):
        assert (sl_np[order[starts[u]:starts[u + 1]]] == slices[u]).all()


def test_schedule_is_the_same_on_both_routes(case):
    """From the merged word and from the split planes of the same plan
    (merged-word plans; a split plan has only its split planes)."""
    _, _, tp = case
    op = tsp.SellSpMV(tp, device="cpu")
    a = op.vals_grad_schedule()
    assert a is op.vals_grad_schedule()  # cached on the operator
    b = tsp.vals_grad_schedule(*op.split_planes())
    for u, v in ((a.order, b.order), (a.unit_start, b.unit_start),
                 (a.unit_slice, b.unit_slice)):
        assert torch.equal(u, v)


def test_hub_slice_is_cut_into_units():
    tp = plan_from_arrays(plan_fields(_jax_plan("hub-relsl")))
    sched = tsp.SellSpMV(tp, device="cpu").vals_grad_schedule()
    hub = kcol.HUB_ROW // 128
    units = (sched.unit_slice == hub).sum().item()
    n_hub = int(((tp.slice_of.reshape(-1) == hub)
                 & (tp.rel_tile.reshape(-1) >= 0)).sum())
    assert sched.cap == tsp.VG_CAP <= tsp.VG_RUN
    assert n_hub >= kcol.HUB_ENTRIES and units == -(-n_hub // tsp.VG_CAP)


def test_schedule_checks():
    tp = plan_from_arrays(plan_fields(_jax_plan("small-relsl")))
    op = tsp.SellSpMV(tp, device="cpu")
    rel, sl = tsp._decode_word(op.relsl)
    for cap in (0, tsp.VG_RUN + 1):
        with pytest.raises(ValueError):
            tsp.vals_grad_schedule(rel, sl, cap=cap)
    X = torch.zeros(tp.n_coltiles * 128, 2)
    G = torch.zeros(tp.n_slices * 128, 2)
    good = op.vals_grad_schedule()
    short = tsp.VgSchedule(good.order[1:], good.unit_start, good.unit_slice,
                           good.cap, 0.0)
    wide = tsp.VgSchedule(good.order.long(), good.unit_start,
                          good.unit_slice, good.cap, 0.0)
    for bad in (short, wide):
        with pytest.raises(ValueError):
            tsp.sell_vals_grad(op.lidx, op.tile_base, X, G, relsl=op.relsl,
                               schedule=bad, **op._mat_kw())


def _butterfly(p):
    """The kernel's group_sum over the last axis of eight partials: xor 4,
    then 2, then 1, as lane 0 of the group ends up with it."""
    p = p + p[..., [4, 5, 6, 7, 0, 1, 2, 3]]
    p = p + p[..., [2, 3, 0, 1, 6, 7, 4, 5]]
    p = p + p[..., [1, 0, 3, 2, 5, 4, 7, 6]]
    return p[..., 0]


def _walk(tp, sched, X, G):
    """The kernel's by-slice walk in numpy float32, in its summation
    order; X (CT·128, k) float32 (bf16 values widened), G (NS·128, k)."""
    k = X.shape[1]
    W = 4 if k % 4 == 0 else 1
    cols = 8 * W
    kp = -(-k // cols) * cols
    Xp = np.zeros((X.shape[0], kp), np.float32)
    Xp[:, :k] = X
    Gp = np.zeros((G.shape[0], kp), np.float32)
    Gp[:, :k] = G
    rel = tp.rel_tile.reshape(-1).astype(np.int64)
    lidx = tp.lane_idx.reshape(-1, 128).astype(np.int64)
    out = np.full((tp.n_sublanes, 128), np.nan, np.float32)
    order = sched.order.numpy()
    starts = sched.unit_start.numpy()
    for u, sl in enumerate(sched.unit_slice.numpy()):
        sid = order[starts[u]:starts[u + 1]]
        if sl < 0:
            out[sid] = 0.0
            continue
        xrow = (tp.tile_base.astype(np.int64)[sid // tp.chunk] + rel[sid]) * 128
        li = lidx[sid]                               # (n, 128)
        acc = np.zeros((sid.size, 128), np.float32)    # lanes of index 0
        part = np.zeros((sid.size, 128, 8), np.float32)  # the others
        for c0 in range(0, kp, cols):
            g = Gp[sl * 128:(sl + 1) * 128, c0:c0 + cols]   # (128, cols)
            xs = Xp[xrow, c0:c0 + cols]                     # (n, cols)
            p0 = np.zeros((sid.size, 128), np.float32)
            for c in range(cols):  # the tile row
                p0 = p0 + g[None, :, c] * xs[:, None, c]
            acc = acc + p0
            xg = Xp[xrow[:, None] + li, c0:c0 + cols]       # (n, 128, cols)
            prod = (g[None] * xg).reshape(sid.size, 128, 8, W)
            for e in range(W):  # thread q's columns, in order
                part = part + prod[..., e]
        out[sid] = np.where(li == 0, acc, _butterfly(part))
    return out


@pytest.mark.parametrize("k", [1, 2, 8, 17, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_walk_matches_plain_and_jax(case, dtype, k):
    name, jp, tp = case
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    jop = jsp.SellSpMV(jp, value_dtype=jdt)
    route = "relsl" if name.endswith("relsl") else "split"
    assert op.route == route
    rng = np.random.default_rng(k)
    X = rng.standard_normal((tp.shape[1], k)).astype(np.float32)
    G = rng.standard_normal((tp.shape[0], k)).astype(np.float32)
    Xt = op._block(torch.from_numpy(X), tp.n_coltiles * 128, tdt, "X")
    Gt = op._block(torch.from_numpy(G), tp.n_slices * 128, torch.float32,
                   "G")
    got = _walk(tp, op.vals_grad_schedule(), Xt.float().numpy(), Gt.numpy())
    assert not np.isnan(got).any()  # every word written
    plain = op.vjp_vals_mat(torch.from_numpy(X), torch.from_numpy(G)).numpy()
    if k == 1:
        want = jop.vjp_vals(jnp.asarray(X[:, 0]), jnp.asarray(G[:, 0]))
    else:
        want = jop.vjp_vals_mat(jnp.asarray(X), jnp.asarray(G))
    want = np.asarray(want)
    assert autograd._rel(got, plain) <= TOL_PLANE
    assert autograd._rel(got, want) <= TOL_PLANE
    dead = (tp.rel_tile.reshape(-1) < 0) | (tp.slice_of.reshape(-1) < 0)
    assert not got[dead].any()
    live = ~dead
    assert np.count_nonzero(got[live]) > np.count_nonzero(tp.vals[live])
