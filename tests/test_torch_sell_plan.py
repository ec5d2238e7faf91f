"""SELL-T1 planner: every plan field equal to the JAX planner's.

The JAX package plans with its native C++ pass when built (bit-identical
to its numpy path); the port copies the numpy path. Also the rel‖slice
plane, the int8/int32 lane-index rule, ``plan_from_arrays`` round trips
and the Hopper kernels' plan gates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.utils.synth import synth_banded
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import plan_checks
from smvp_toolkit_tpu_torch.ops import sell_plan as tplan
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

from conftest import random_coo

import torch_kcol_plans as kcol


def _triplets(name):
    if name == "synth":
        r, c, v = synth_banded(20000, nnz_per_row=9).to_numpy()
        return r, c, np.asarray(v), (20000, 20000)
    if name == "rect-empty-rows":
        rng = np.random.RandomState(1)
        r, c, v = random_coo(rng, 3000, 5000, 30000)
        r = (r // 2) * 2  # odd rows empty
        return r, c, v, (3000, 5000)
    if name == "dups":
        rng = np.random.RandomState(2)
        r, c, v = random_coo(rng, 700, 700, 20000, allow_duplicates=True)
        return r, c, v, (700, 700)
    if name == "nnz0":
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0), (1000, 300)
    if name == "tiny":
        return (np.array([0, 5, 9], np.int32), np.array([3, 3, 200], np.int32),
                np.array([1.0, -2.0, 0.5]), (10, 300))
    raise AssertionError(name)


CASES = [
    # (matrix, kwargs)
    ("synth", dict(chunk=2048)),
    ("synth", dict(chunk=1024)),
    ("synth", dict(chunk=200, allow_small_chunk=False)),  # int32 lidx
    ("rect-empty-rows", dict(chunk=2048)),
    ("rect-empty-rows", dict(chunk=256, min_window_tiles=32)),
    ("dups", dict(chunk=512)),
    ("nnz0", dict(chunk=2048)),
    ("nnz0", dict(chunk=96, allow_small_chunk=False)),
    ("tiny", dict(chunk=2048)),
]
IDS = [f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for m, kw in CASES]


def _plans(name, kw):
    r, c, v, shape = _triplets(name)
    return (tplan.build_sell_plan(r, c, v, shape, **kw),
            jplan.build_sell_plan(r, c, v, shape, **kw))


def _assert_plans_equal(t, j):
    for f in dataclasses.fields(jplan.SellPlan):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_every_plan_field_equal(name, kw):
    t, j = _plans(name, kw)
    assert [f.name for f in dataclasses.fields(tplan.SellPlan)] == \
        [f.name for f in dataclasses.fields(jplan.SellPlan)]
    _assert_plans_equal(t, j)
    assert (t.n_sublanes, t.n_chunks, t.slots()) == \
        (j.n_sublanes, j.n_chunks, j.slots())
    tb, tn = t.reduce_window()
    jb, jn = j.reduce_window()
    assert tn == jn and tb.tobytes() == jb.tobytes()


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_relsl_plane_and_lidx_rule(name, kw):
    t, j = _plans(name, kw)
    rt, rj = tsp.relsl_plane_host(t), jsp.relsl_plane_host(j)
    assert rt.dtype == rj.dtype == np.int32
    assert rt.tobytes() == rj.tobytes()
    op = jsp.SellSpMV(j)
    want = torch.int8 if op.lidx.dtype == np.int8 else torch.int32
    assert tsp.lidx_dtype(t.chunk) == want


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_traffic_bytes(name, kw):
    t, j = _plans(name, kw)
    s = t.n_sublanes
    for vb in (4, 2):
        # JAX charges split rel_tile + slice_of planes (8 B/sublane); the
        # port's kernels read one merged word (4 B/sublane).
        assert t.traffic_bytes(vb, x_bytes=vb) == j.traffic_bytes(
            vb, x_bytes=vb, x_resident=True) - 4 * s


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_plan_from_arrays_round_trips_jax_plan(name, kw):
    _, j = _plans(name, kw)
    fields = plan_fields(j)
    assert all(isinstance(v, (np.ndarray, int, tuple)) or v is None
               for v in fields.values())
    _assert_plans_equal(plan_from_arrays(fields), j)


def test_plan_from_arrays_rejects_unknown_fields():
    _, j = _plans("tiny", {})
    fields = plan_fields(j)
    fields["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        plan_from_arrays(fields)


def test_plan_gates():
    t, _ = _plans("tiny", {})
    plan_checks.check_plan(t)
    # A window past the 9-bit rel field or a slice count past the 23-bit
    # slice field is no longer refused: such plans run on the split planes.
    wide = dataclasses.replace(t, window_tiles=512)
    plan_checks.check_plan(wide)
    assert tsp.plan_route(wide) == "split"
    tall = dataclasses.replace(t, n_slices=plan_checks.SLICE_DEAD)
    plan_checks.check_plan(tall)
    assert tsp.plan_route(tall) == "split"
    # A plan that breaks an invariant the kernels index by still raises.
    with pytest.raises(ValueError, match="y_block_id"):
        plan_checks.check_plan(dataclasses.replace(t, y_block_slices=512))
    bad_lidx = t.lane_idx.copy()
    bad_lidx[0, 0] = 128
    with pytest.raises(ValueError, match="lane"):
        plan_checks.check_plan(dataclasses.replace(t, lane_idx=bad_lidx))
    with pytest.raises(ValueError, match="outside y"):
        plan_checks.check_plan(dataclasses.replace(t, n_slices=0))
    with pytest.raises(ValueError, match="outside x"):
        plan_checks.check_plan(dataclasses.replace(
            t, tile_base=t.tile_base + t.n_coltiles))
    with pytest.raises(ValueError, match="outside x"):
        plan_checks.check_plan(dataclasses.replace(
            t, tile_base=t.tile_base - 16))
    with pytest.raises(ValueError, match="window"):
        plan_checks.check_plan(dataclasses.replace(t, window_tiles=1))
    with pytest.raises(ValueError, match="slice_of"):
        plan_checks.check_plan(dataclasses.replace(
            t, slice_of=t.slice_of.astype(np.int64)))
    with pytest.raises(ValueError, match="rel_tile"):
        plan_checks.check_plan(dataclasses.replace(t, rel_tile=t.rel_tile[1:]))


def test_streamed_y_plan_refused():
    """A streamed-y plan is refused only where it breaks an invariant."""
    r, c, v, _ = _triplets("tiny")
    rows = np.array([0, 2100, 4200, 5000])
    good = tplan.build_streamed_sell_plan(
        rows, np.array([3, 3, 200, 7]), np.array([1.0, -2.0, 0.5, 4.0]),
        (6000, 300), chunk=8, y_block_rows=2048)
    assert tsp.SellSpMV(good, device="cpu").route == "streamy_relsl"
    blk = good.y_block_id
    bad = {
        "non-decreasing": dict(y_block_id=blk[::-1].copy()),
        "outside y": dict(y_block_id=blk + 1),
        "y block": dict(slice_of=np.where(good.slice_of >= 0, 16,
                                          good.slice_of).astype(np.int32)),
        "y_block_id": dict(y_block_id=blk[:-1]),
    }
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            tsp.SellSpMV(dataclasses.replace(good, **change), device="cpu")
    # the JAX planner's streamed plan crosses over and runs
    streamed = jplan.build_streamed_sell_plan(r, c, v, (10, 300), chunk=8)
    op = tsp.SellSpMV(plan_from_arrays(plan_fields(streamed)), device="cpu")
    y = op(torch.ones(300))
    assert y.shape == (10,) and y[0] == 1.0 and y[5] == -2.0 and y[9] == 0.5


def test_auto_plan_matches_jax_auto_plan():
    r, c, v, shape = _triplets("synth")
    _assert_plans_equal(tsp._auto_plan(r, c, v, shape),
                        jsp._auto_plan(r, c, v, shape))


def test_complex_values_refused():
    with pytest.raises(TypeError):
        tplan.build_sell_plan(np.array([0]), np.array([0]),
                              np.array([1j]), (1, 1))


def _powerlaw():
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    r, c, v = synth_powerlaw(20000, 200000, seed=0, device="cpu").to_numpy()
    return r, c, np.asarray(v), (20000, 20000)


@pytest.mark.parametrize("planner", ["port", "jax"])
@pytest.mark.parametrize("name,chunk", [("powerlaw", 2048), ("dups", 512),
                                        ("dups", 64)])
def test_cell_sublanes_adjacent_in_plan_order(planner, name, chunk):
    """The premise of the k-column kernels' run-summing: every live
    sublane of one (tile, slice) cell (a row's duplicate sublanes in one
    column tile) lies next to the others in plan order, in the port's
    planner and in the JAX planner, on a powerlaw plan (hub rows) and on
    a plan with duplicate coordinates; and runs of several sublanes
    occur."""
    r, c, v, shape = _powerlaw() if name == "powerlaw" else _triplets(name)
    build = (tplan if planner == "port" else jplan).build_sell_plan
    plan = build(r, c, v, shape, chunk=chunk)
    assert kcol.cells_adjacent(plan)
    assert kcol.runs(plan)[:, 1].max() > 1


@pytest.mark.parametrize("route", ["relsl", "split"])
def test_hub_row_runs_past_a_work_item(route):
    """``hub_row_plan``'s row of 200 entries in one tile is one run of at
    least 200 sublanes (a random entry may join it) that crosses 64-sublane
    work items, on the route named."""
    plan = kcol.hub_row_plan(route)
    assert tsp.SellSpMV(plan, device="cpu").route == route
    rr = kcol.runs(plan)
    first, length = rr[np.argmax(rr[:, 1])]
    assert length >= kcol.HUB_ENTRIES
    assert first // kcol.ITEM != (first + length - 1) // kcol.ITEM
